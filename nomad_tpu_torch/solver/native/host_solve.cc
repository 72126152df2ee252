// Native host solve: the interactive-latency engine of the host route.
//
// A singleton eval on a small cluster finishes its arithmetic in tens
// of microseconds; the numpy twin (solver/host.py host_solve_kernel)
// pays about a millisecond of interpreter and ufunc overhead for the
// same math.  This translation unit is a line-for-line port of that
// numpy kernel (same wave loop, same f32 formulas, same tie-breaks,
// same gather / scatter edge semantics), built with g++ at first use
// and driven through ctypes (solver/native.py).
// tests/test_torch_native_solver.py holds it equal to the numpy twin,
// which is itself held against the torch wave solve.
//
// Reference analog: the in-process Go solve (scheduler/generic_sched.go
// :427 SetJob -> stack.Select).
//
// Everything is plain C++17 + libm; no external dependencies.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int TOP_K = 4;
constexpr float NEG_INF = -1e30f;
constexpr float SCORE_BIN = 0.05f;

// op codes (solver/tensorize.py)
enum { OP_NONE = 0, OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE,
       OP_IS_SET, OP_NOT_SET };

struct Shape {
  int Np, Gp, A, C, CA, S, V, R, D, K;
};

inline bool op_eval(int32_t val, int32_t op, int32_t rank) {
  const bool found = val >= 0;
  switch (op) {
    case OP_EQ: return found && val == rank;
    case OP_NE: return !(found && val == rank);
    case OP_LT: return found && val < rank;
    case OP_LE: return found && val <= rank;
    case OP_GT: return found && val > rank;
    case OP_GE: return found && val >= rank;
    case OP_IS_SET: return found;
    case OP_NOT_SET: return !found;
    default: return true;
  }
}

// exact descending top-k per row; ties -> lower index first (the
// numpy twin's stable argsort of -score)
void top_k_row(const float* score, int n, int k, float* out_s,
               int32_t* out_i, std::vector<int>& scratch) {
  scratch.resize(n);
  for (int i = 0; i < n; ++i) scratch[i] = i;
  const int kk = std::min(k, n);
  std::partial_sort(scratch.begin(), scratch.begin() + kk, scratch.end(),
                    [&](int a, int b) {
                      if (score[a] != score[b]) return score[a] > score[b];
                      return a < b;
                    });
  for (int i = 0; i < kk; ++i) {
    out_i[i] = static_cast<int32_t>(scratch[i]);
    out_s[i] = score[scratch[i]];
  }
  for (int i = kk; i < k; ++i) {   // n < k pad (cannot happen: TK<=Np)
    out_i[i] = 0;
    out_s[i] = NEG_INF;
  }
}

}  // namespace

extern "C" int nomad_host_solve(
    // node template
    const float* avail, const float* reserved, float* used,
    const uint8_t* valid, const int32_t* node_dc, const int32_t* attr_rank,
    // ask programs
    const float* ask_res, const float* ask_desired, const int32_t* distinct,
    const uint8_t* dc_ok, const uint8_t* host_ok, const float* coll0,
    const uint8_t* penalty, const int32_t* c_op, const int32_t* c_col,
    const int32_t* c_rank, const int32_t* a_op, const int32_t* a_col,
    const int32_t* a_rank, const float* a_weight, const float* a_host,
    const int32_t* sp_col, const float* sp_weight, const uint8_t* sp_targeted,
    const float* sp_desired, const float* sp_implicit, float* sp_used,
    const float* dev_cap, float* dev_used, const float* dev_ask,
    const int32_t* p_ask, int n_place,
    // shape + mode
    int Np, int Gp, int A, int C, int CA, int S, int V, int R, int D, int K,
    int NDC, int seed, int has_spread, int group_count_hint, int max_waves,
    int stack_commit, int w_cap,
    // outputs
    int32_t* out_idx, uint8_t* out_ok, float* out_score,
    int32_t* out_nfeas, int32_t* out_nexh, int32_t* out_dimexh,
    uint8_t* out_unfinished, int32_t* out_waves,
    uint8_t* out_feas, int32_t* out_consf,
    // optional static-program cache (PreparedRun): when static_ready
    // is nonzero, feas/aff/spread hoists are READ from these buffers
    // instead of recomputed; on a 0->1 first run they are filled.
    // Null buffers = compute locally every call (the generic path).
    int static_ready, uint8_t* feas_buf, float* aff_buf,
    int32_t* consf_buf, int32_t* spv_buf, float* spd_buf) {
  const int per_group = group_count_hint > 0 ? group_count_hint : K / 8;
  const int WAVE_K = 32;
  const int TK = std::min(std::max(WAVE_K, std::min(2 * per_group, w_cap))
                          + TOP_K, Np);
  const int W = std::max(TK - TOP_K, 1);

  // ---------- wave-invariant program ----------
  std::vector<uint8_t> feas_loc;
  std::vector<float> aff_loc;
  std::vector<int32_t> consf_loc;
  std::vector<int32_t> spv_loc;
  std::vector<float> spd_loc;
  const bool cached = feas_buf != nullptr;
  if (!cached) {
    feas_loc.resize(static_cast<size_t>(Gp) * Np);
    aff_loc.resize(static_cast<size_t>(Gp) * Np);
    consf_loc.assign(static_cast<size_t>(Gp) * C, 0);
  }
  uint8_t* feas = cached ? feas_buf : feas_loc.data();
  float* aff = cached ? aff_buf : aff_loc.data();
  int32_t* consf = cached ? consf_buf : consf_loc.data();
  if (!(cached && static_ready)) {
  if (cached) std::fill(consf, consf + static_cast<size_t>(Gp) * C, 0);
  for (int g = 0; g < Gp; ++g) {
    for (int n = 0; n < Np; ++n) {
      const bool base = valid[n] && dc_ok[g * NDC + node_dc[n]]
                        && host_ok[g * Np + n];
      bool all_ok = true;
      bool failed_already = false;
      for (int c = 0; c < C; ++c) {
        const int32_t col = c_col[g * C + c];
        const int32_t v = attr_rank[n * A + col];
        const bool ok = op_eval(v, c_op[g * C + c], c_rank[g * C + c]);
        if (!ok) {
          if (base && !failed_already) consf[g * C + c] += 1;
          failed_already = true;
          all_ok = false;
        }
      }
      feas[g * Np + n] = base && all_ok;
      // f32 accumulation order matches the numpy twin: sum the
      // affinity weights first, then add a_host
      float a = 0.0f;
      for (int c = 0; c < CA; ++c) {
        const int32_t col = a_col[g * CA + c];
        const int32_t v = attr_rank[n * A + col];
        if (op_eval(v, a_op[g * CA + c], a_rank[g * CA + c]))
          a += a_weight[g * CA + c];
      }
      aff[g * Np + n] = a + a_host[g * Np + n];
    }
  }
  }  // end !(cached && static_ready)
  // hoisted spread lookups
  if (!cached && has_spread) {
    spv_loc.resize(static_cast<size_t>(S) * Gp * Np);
    spd_loc.resize(static_cast<size_t>(S) * Gp * Np);
  }
  int32_t* sp_vnode = cached ? spv_buf : spv_loc.data();
  float* sp_des = cached ? spd_buf : spd_loc.data();
  if (has_spread && !(cached && static_ready)) {
    for (int s = 0; s < S; ++s) {
      for (int g = 0; g < Gp; ++g) {
        const int32_t col = sp_col[g * S + s];
        for (int n = 0; n < Np; ++n) {
          int32_t v = attr_rank[n * A + std::max(col, 0)];
          if (col < 0) v = -1;
          // XLA gather: clamp OOB
          float desired = sp_desired[(g * S + s) * V
                                     + std::min(std::max(v, 0), V - 1)];
          if (v < 0) desired = -1.0f;
          if (desired < 0) desired = sp_implicit[g * S + s];
          sp_vnode[(static_cast<size_t>(s) * Gp + g) * Np + n] = v;
          sp_des[(static_cast<size_t>(s) * Gp + g) * Np + n] = desired;
        }
      }
    }
  }

  // tie-break jitter (bit-exact uint32 hash of the jitted kernel)
  std::vector<float> jitter(static_cast<size_t>(Gp) * Np, 0.0f);
  if (seed != 0) {
    for (int g = 0; g < Gp; ++g) {
      const uint32_t gh = static_cast<uint32_t>(g) * 7919u
                          + static_cast<uint32_t>(seed);
      for (int n = 0; n < Np; ++n) {
        uint32_t h = static_cast<uint32_t>(n) * 2654435761u
                     + gh * 40503u;
        h = (h ^ (h >> 16)) * 2246822519u;
        jitter[g * Np + n] = static_cast<float>(h & 1023u)
                             * (SCORE_BIN / 1023.0f);
      }
    }
  }
  std::vector<int32_t> g_off(Gp, 0);
  if (seed != 0) {
    for (int g = 0; g < Gp; ++g) {
      const uint32_t gh = (static_cast<uint32_t>(g) * 2654435761u)
                          ^ (static_cast<uint32_t>(seed) * 2246822519u);
      g_off[g] = static_cast<int32_t>((gh >> 8) % static_cast<uint32_t>(W));
    }
  }

  // ---------- resource-row dedup ----------
  // binpack and raw fit depend on (g, n) only through ask_res[g] /
  // dev_ask[g]; most batches carry few distinct rows (config-1's ten
  // groups share four).  Computing the expensive pieces once per
  // DISTINCT row per wave cuts the powf count by the duplication
  // factor with bit-identical results.
  std::vector<int> row_id(Gp, 0);
  std::vector<int> row_rep;                   // first g of each row
  for (int g = 0; g < Gp; ++g) {
    int found = -1;
    for (size_t r = 0; r < row_rep.size(); ++r) {
      const int g2 = row_rep[r];
      if (std::memcmp(ask_res + g * R, ask_res + g2 * R,
                      sizeof(float) * R) == 0
          && std::memcmp(dev_ask + g * D, dev_ask + g2 * D,
                         sizeof(float) * D) == 0) {
        found = static_cast<int>(r);
        break;
      }
    }
    if (found < 0) {
      found = static_cast<int>(row_rep.size());
      row_rep.push_back(g);
    }
    row_id[g] = found;
  }
  const int NR = static_cast<int>(row_rep.size());

  // ---------- wave state ----------
  std::vector<uint8_t> done(K, 0);
  std::fill(out_idx, out_idx + static_cast<size_t>(K) * TOP_K, 0);
  std::fill(out_ok, out_ok + static_cast<size_t>(K) * TOP_K, 0);
  std::fill(out_score, out_score + static_cast<size_t>(K) * TOP_K, NEG_INF);
  std::fill(out_nfeas, out_nfeas + K, 0);
  std::fill(out_nexh, out_nexh + K, 0);
  std::fill(out_dimexh, out_dimexh + static_cast<size_t>(K) * R, 0);

  std::vector<float> score(static_cast<size_t>(Gp) * Np);
  std::vector<uint8_t> placeable(static_cast<size_t>(Gp) * Np);
  std::vector<uint8_t> feas_b(static_cast<size_t>(Gp) * Np);
  // per distinct resource row (not per group): raw fit, per-dim fit,
  // device fit, binpack score
  std::vector<uint8_t> row_fit(static_cast<size_t>(NR) * Np);
  std::vector<uint8_t> row_fitd(static_cast<size_t>(NR) * Np * R);
  std::vector<uint8_t> row_devfit(static_cast<size_t>(NR) * Np);
  std::vector<float> row_binpack(static_cast<size_t>(NR) * Np);
  std::vector<float> coll(static_cast<size_t>(Gp) * Np);
  std::vector<uint8_t> blocked(static_cast<size_t>(Gp) * Np);
  std::vector<int32_t> hit(static_cast<size_t>(Gp) * Np);
  std::vector<float> top_s(static_cast<size_t>(Gp) * TK);
  std::vector<int32_t> top_i(static_cast<size_t>(Gp) * TK);
  std::vector<int> scratch;
  std::vector<float> sv_row(Np);
  std::vector<int32_t> rank(K), cand(K), Mg(Gp), n_cand(Gp), act_g(Gp);
  std::vector<uint8_t> cand_okv(K), commitv(K), fail_nowv(K);
  std::vector<float> cand_s(K);
  std::vector<int32_t> nfeas_g(Gp), nexh_g(Gp);
  std::vector<int32_t> dimexh_g(static_cast<size_t>(Gp) * R);
  std::vector<uint8_t> grp_any(Gp);
  // interleave scratch
  const int Vs = V;
  const bool interleave = has_spread && Vs <= 8 && !stack_commit;
  const int TKv = interleave ? (TK + Vs) / (Vs + 1) : 0;
  std::vector<float> tab_s;
  std::vector<int32_t> tab_i;
  std::vector<int> vord(Vs + 1);
  std::vector<float> int_s(TK);
  std::vector<int32_t> int_i(TK);

  int wave = 0;
  for (; wave < max_waves; ++wave) {
    bool any_active = false;
    for (int p = 0; p < n_place && p < K; ++p)
      if (!done[p]) { any_active = true; break; }
    if (!any_active) break;

    // rebuild coll / distinct blocking from committed outputs
    std::memcpy(coll.data(), coll0,
                sizeof(float) * static_cast<size_t>(Gp) * Np);
    std::fill(hit.begin(), hit.end(), 0);
    for (int p = 0; p < K; ++p) {
      if (done[p] && out_ok[p * TOP_K]) {
        const int g = p_ask[p];
        const int ch = out_idx[p * TOP_K];
        coll[g * Np + ch] += 1.0f;
        const int32_t dg = distinct[g];
        if (dg >= 0) hit[dg * Np + ch] += 1;
      }
    }
    for (int g = 0; g < Gp; ++g) {
      const int32_t dg = distinct[g];
      for (int n = 0; n < Np; ++n)
        blocked[g * Np + n] =
            dg >= 0 && hit[std::max(dg, 0) * Np + n] > 0;
    }

    // ---------- batched scoring ----------
    // per-row pass: fit, per-dim fit, device fit, binpack (the powf
    // pair) computed once per DISTINCT resource row
    for (int rr = 0; rr < NR; ++rr) {
      const int g0 = row_rep[rr];
      for (int n = 0; n < Np; ++n) {
        bool fit = true;
        for (int r = 0; r < R; ++r) {
          const float after = used[n * R + r] + ask_res[g0 * R + r];
          const bool fd = after <= avail[n * R + r];
          row_fitd[(rr * Np + n) * R + r] = fd;
          fit = fit && fd;
        }
        bool dfit = true;
        for (int d = 0; d < D; ++d)
          dfit = dfit && (dev_used[n * D + d] + dev_ask[g0 * D + d]
                          <= dev_cap[n * D + d]);
        row_fit[rr * Np + n] = fit;
        row_devfit[rr * Np + n] = dfit;
        const float denom_cpu = avail[n * R + 0];
        const float denom_mem = avail[n * R + 1];
        float binpack = 0.0f;
        if (fit && dfit && denom_cpu > 0 && denom_mem > 0) {
          const float util_cpu = used[n * R + 0] + ask_res[g0 * R + 0]
                                 + reserved[n * R + 0];
          const float util_mem = used[n * R + 1] + ask_res[g0 * R + 1]
                                 + reserved[n * R + 1];
          const float free_cpu =
              1.0f - util_cpu / std::max(denom_cpu, 1.0f);
          const float free_mem =
              1.0f - util_mem / std::max(denom_mem, 1.0f);
          float raw = 20.0f - (std::pow(10.0f, free_cpu)
                               + std::pow(10.0f, free_mem));
          raw = std::min(std::max(raw, 0.0f), 18.0f);
          binpack = raw / 18.0f;
        }
        row_binpack[rr * Np + n] = binpack;
      }
    }
    for (int g = 0; g < Gp; ++g) {
      const float adesired = ask_desired[g];
      const int rr = row_id[g];
      int nf = 0, ne = 0;
      int de[8] = {0};
      bool ga = false;
      for (int n = 0; n < Np; ++n) {
        const bool fit = row_fit[rr * Np + n];
        const bool dfit = row_devfit[rr * Np + n];
        const bool fb = feas[g * Np + n] && !blocked[g * Np + n];
        feas_b[g * Np + n] = fb;
        const bool pl = fb && fit && dfit;
        placeable[g * Np + n] = pl;
        ga = ga || pl;
        if (fb && valid[n]) {
          ++nf;
          if (!(fit && dfit)) ++ne;
          for (int r = 0; r < R && r < 8; ++r)
            if (!row_fitd[(rr * Np + n) * R + r]) ++de[r];
        }
        if (!pl) {
          // unplaceable: the numpy twin computes-then-discards; the
          // score is NEG_INF either way and nothing below reads more
          score[g * Np + n] = NEG_INF;
          continue;
        }
        const float binpack = row_binpack[rr * Np + n];
        const float cl = coll[g * Np + n];
        const float anti = cl > 0 ? -(cl + 1.0f) / adesired : 0.0f;
        const float pen = penalty[g * Np + n] ? -1.0f : 0.0f;
        const float af = aff[g * Np + n];
        float sp_total = 0.0f;
        if (has_spread) {
          for (int s = 0; s < S; ++s) {
            const int32_t col = sp_col[g * S + s];
            const int32_t v =
                sp_vnode[(static_cast<size_t>(s) * Gp + g) * Np + n];
            const float* uv = sp_used + (g * S + s) * V;
            float cur = 0.0f;
            if (v >= 0)
              cur = uv[std::min(std::max(v, 0), V - 1)];
            float minc = std::numeric_limits<float>::infinity();
            float maxc = -std::numeric_limits<float>::infinity();
            bool anyp = false;
            for (int vv = 0; vv < V; ++vv) {
              if (uv[vv] > 0) {
                anyp = true;
                minc = std::min(minc, uv[vv]);
                maxc = std::max(maxc, uv[vv]);
              }
            }
            float contrib;
            if (sp_targeted[g * S + s]) {
              const float desired =
                  sp_des[(static_cast<size_t>(s) * Gp + g) * Np + n];
              const float boost = (desired - (cur + 1.0f))
                                  / std::max(desired, 1e-9f)
                                  * sp_weight[g * S + s];
              contrib = (v < 0) ? -1.0f : (desired <= 0 ? -1.0f : boost);
            } else {
              float even;
              if (!anyp) {
                even = (v < 0) ? -1.0f : 0.0f;
              } else if (cur != minc) {
                even = (minc - cur) / std::max(minc, 1e-9f);
              } else if (minc == maxc) {
                even = -1.0f;
              } else {
                even = (maxc - minc) / std::max(minc, 1e-9f);
              }
              if (v < 0) even = -1.0f;
              if (!anyp) even = 0.0f;
              contrib = even;
            }
            if (col >= 0) sp_total += contrib;
          }
        }
        const bool sp_cnt = sp_total != 0.0f;
        const bool anti_cnt = cl > 0;
        const bool pen_cnt = penalty[g * Np + n];
        const bool aff_cnt = af != 0.0f;
        const float n_scorers = 1.0f + (anti_cnt ? 1.0f : 0.0f)
                                + (pen_cnt ? 1.0f : 0.0f)
                                + (aff_cnt ? 1.0f : 0.0f)
                                + (sp_cnt ? 1.0f : 0.0f);
        float total = (binpack + anti + pen + af + sp_total) / n_scorers;
        if (seed != 0)
          total = std::floor(total / SCORE_BIN) * SCORE_BIN;
        total += jitter[g * Np + n];
        score[g * Np + n] = pl ? total : NEG_INF;
      }
      grp_any[g] = ga;
      nfeas_g[g] = nf;
      nexh_g[g] = ne;
      for (int r = 0; r < R && r < 8; ++r) dimexh_g[g * R + r] = de[r];
    }

    // ---------- per-group top-k (+ optional spread interleave) ----------
    for (int g = 0; g < Gp; ++g)
      top_k_row(score.data() + static_cast<size_t>(g) * Np, Np, TK,
                top_s.data() + static_cast<size_t>(g) * TK,
                top_i.data() + static_cast<size_t>(g) * TK, scratch);

    if (interleave) {
      tab_s.assign(static_cast<size_t>(Vs + 1) * TKv, NEG_INF);
      tab_i.assign(static_cast<size_t>(Vs + 1) * TKv, 0);
      for (int g = 0; g < Gp; ++g) {
        if (!(sp_col[g * S + 0] >= 0)) continue;
        const int32_t* vnode =
            sp_vnode + static_cast<size_t>(0) * Gp * Np + g * Np;
        for (int v = 0; v <= Vs; ++v) {
          for (int n = 0; n < Np; ++n) {
            const bool vm = (v < Vs) ? (vnode[n] == v) : (vnode[n] < 0);
            sv_row[n] = vm ? score[g * Np + n] : NEG_INF;
          }
          top_k_row(sv_row.data(), Np, TKv,
                    tab_s.data() + static_cast<size_t>(v) * TKv,
                    tab_i.data() + static_cast<size_t>(v) * TKv, scratch);
        }
        // value visit order: best head candidate first (stable)
        for (int v = 0; v <= Vs; ++v) vord[v] = v;
        std::stable_sort(vord.begin(), vord.end(), [&](int a, int b) {
          return tab_s[static_cast<size_t>(a) * TKv]
                 > tab_s[static_cast<size_t>(b) * TKv];
        });
        for (int j = 0; j < TK; ++j) {
          const int vj = vord[j % (Vs + 1)];
          const int row = j / (Vs + 1);
          int_i[j] = tab_i[static_cast<size_t>(vj) * TKv + row];
          int_s[j] = tab_s[static_cast<size_t>(vj) * TKv + row];
        }
        // compact holes to the tail (stable partition by finiteness)
        int w = 0;
        for (int j = 0; j < TK; ++j)
          if (int_s[j] > NEG_INF / 2) {
            top_i[static_cast<size_t>(g) * TK + w] = int_i[j];
            top_s[static_cast<size_t>(g) * TK + w] = int_s[j];
            ++w;
          }
        for (int j = 0; j < TK; ++j)
          if (!(int_s[j] > NEG_INF / 2)) {
            top_i[static_cast<size_t>(g) * TK + w] = int_i[j];
            top_s[static_cast<size_t>(g) * TK + w] = int_s[j];
            ++w;
          }
      }
    }

    // ---------- candidate assignment ----------
    std::fill(act_g.begin(), act_g.end(), 0);
    for (int p = 0; p < K; ++p) {
      const bool active = !done[p] && p < n_place;
      rank[p] = active ? act_g[p_ask[p]]++ : 0;
    }
    for (int g = 0; g < Gp; ++g) {
      int nc = 0;
      for (int j = 0; j < TK; ++j)
        if (top_s[static_cast<size_t>(g) * TK + j] > NEG_INF / 2) ++nc;
      n_cand[g] = nc;
      Mg[g] = std::min(std::max(std::min(nc, W), 1), W);
    }
    const int rot = (seed == 0) ? 0 : wave;
    for (int p = 0; p < K; ++p) {
      const bool active = !done[p] && p < n_place;
      const int g = p_ask[p];
      const int cr = stack_commit
          ? 0 : (rank[p] + g_off[g] + rot) % Mg[g];
      cand[p] = top_i[static_cast<size_t>(g) * TK + cr];
      cand_s[p] = top_s[static_cast<size_t>(g) * TK + cr];
      cand_okv[p] = active && cand_s[p] > NEG_INF / 2;
      fail_nowv[p] = active && !grp_any[g];
      rank[p] = cr;  // keep the slot for the fall-through record below
    }

    // ---------- same-wave conflict checks (serial, index order) ----------
    // per-node cumulative resource fit
    {
      std::vector<std::pair<int, std::vector<float>>> dummy;  // unused
      // prior resource sums per node via flat maps (K is small here)
      std::vector<float> prior(static_cast<size_t>(K) * R, 0.0f);
      std::vector<float> prior_dev(static_cast<size_t>(K) * D, 0.0f);
      {
        // node -> accumulated vec; use a dense [Np, R] accumulator
        std::vector<float> accR(static_cast<size_t>(Np) * R, 0.0f);
        std::vector<float> accD(static_cast<size_t>(Np) * D, 0.0f);
        for (int p = 0; p < K; ++p) {
          if (!cand_okv[p]) continue;
          const int n = cand[p];
          const int g = p_ask[p];
          for (int r = 0; r < R; ++r) {
            prior[p * R + r] = accR[n * R + r];
            accR[n * R + r] += ask_res[g * R + r];
          }
          for (int d = 0; d < D; ++d) {
            prior_dev[p * D + d] = accD[n * D + d];
            accD[n * D + d] += dev_ask[g * D + d];
          }
        }
      }
      // distinct rank + spread quota ranks
      std::vector<int32_t> dg_rank(K, 0);
      if (true) {
        std::vector<int32_t> cnt(static_cast<size_t>(Np) * Gp, 0);
        for (int p = 0; p < K; ++p) {
          const int g = p_ask[p];
          const int32_t dg = distinct[g];
          if (!(cand_okv[p] && dg >= 0)) continue;
          dg_rank[p] = cnt[cand[p] * Gp + dg]++;
        }
      }
      std::vector<uint8_t> sp_okv(K, 1);
      if (has_spread) {
        std::vector<int32_t> gv_cnt;
        for (int s = 0; s < S; ++s) {
          gv_cnt.assign(static_cast<size_t>(Gp) * V, 0);
          for (int p = 0; p < K; ++p) {
            if (!cand_okv[p]) continue;
            const int g = p_ask[p];
            const int32_t col = sp_col[g * S + s];
            const int32_t v = attr_rank[cand[p] * A + std::max(col, 0)];
            const bool has_s = col >= 0 && v >= 0;
            if (!has_s) continue;
            const int vc = std::max(v, 0);
            const int rank_gv = gv_cnt[g * V + std::min(vc, V - 1)]++;
            // quota
            const float* uv = sp_used + (g * S + s) * V;
            float quota;
            if (sp_targeted[g * S + s]) {
              float des = sp_desired[(g * S + s) * V
                                     + std::min(vc, V - 1)];
              if (des < 0) des = sp_implicit[g * S + s];
              quota = std::max(
                  1.0f, des - uv[std::min(vc, V - 1)]);
            } else if (wave < std::max(max_waves / 2, 1)) {
              float minc = std::numeric_limits<float>::infinity();
              float maxc = 0.0f;
              bool anyp = false;
              for (int vv = 0; vv < V; ++vv)
                if (uv[vv] > 0) {
                  anyp = true;
                  minc = std::min(minc, uv[vv]);
                  maxc = std::max(maxc, uv[vv]);
                }
              if (!anyp) minc = 0.0f;
              if (!std::isfinite(minc)) minc = 0.0f;
              const float share =
                  std::ceil(static_cast<float>(act_g[g])
                            / static_cast<float>(V));
              const float level = std::max(maxc, minc + share);
              quota = std::max(1.0f, level - uv[std::min(vc, V - 1)]);
            } else {
              quota = std::numeric_limits<float>::infinity();
            }
            if (!(static_cast<float>(rank_gv) < quota)) sp_okv[p] = 0;
          }
        }
      }

      // ---------- commit ----------
      for (int p = 0; p < K; ++p) {
        const int g = p_ask[p];
        bool fits = true;
        if (cand_okv[p]) {
          for (int r = 0; r < R; ++r)
            fits = fits && (used[cand[p] * R + r] + prior[p * R + r]
                            + ask_res[g * R + r]
                            <= avail[cand[p] * R + r]);
          for (int d = 0; d < D && fits; ++d)
            fits = fits && (dev_used[cand[p] * D + d]
                            + prior_dev[p * D + d] + dev_ask[g * D + d]
                            <= dev_cap[cand[p] * D + d]);
        }
        const int32_t dgv = distinct[g];
        const bool dg_ok = dgv < 0 || dg_rank[p] == 0;
        commitv[p] = cand_okv[p] && fits && dg_ok && sp_okv[p];
      }
    }

    // apply commits + record results
    for (int p = 0; p < K; ++p) {
      const int g = p_ask[p];
      if (commitv[p]) {
        for (int r = 0; r < R; ++r)
          used[cand[p] * R + r] += ask_res[g * R + r];
        for (int d = 0; d < D; ++d)
          dev_used[cand[p] * D + d] += dev_ask[g * D + d];
        if (has_spread) {
          for (int s = 0; s < S; ++s) {
            const int32_t col = sp_col[g * S + s];
            const int32_t v = attr_rank[cand[p] * A + std::max(col, 0)];
            // XLA scatter: OOB updates dropped
            if (col >= 0 && v >= 0 && v < V)
              sp_used[(g * S + s) * V + v] += 1.0f;
          }
        }
      }
      const bool newly = commitv[p] || fail_nowv[p];
      if (newly) {
        const int cr = rank[p];
        for (int t = 0; t < TOP_K; ++t) {
          const int off = cr + t;
          const float s = (off < TK)
              ? top_s[static_cast<size_t>(g) * TK + off] : NEG_INF;
          const int32_t i = (off < TK)
              ? top_i[static_cast<size_t>(g) * TK + off] : 0;
          out_idx[p * TOP_K + t] = i;
          out_score[p * TOP_K + t] = s;
          out_ok[p * TOP_K + t] = (s > NEG_INF / 2) && commitv[p];
        }
        out_nfeas[p] = nfeas_g[g];
        out_nexh[p] = nexh_g[g];
        for (int r = 0; r < R; ++r)
          out_dimexh[p * R + r] = dimexh_g[g * R + r];
        done[p] = 1;
      }
    }
  }

  for (int p = 0; p < K; ++p)
    out_unfinished[p] = !done[p] && p < n_place;
  *out_waves = wave;
  if (out_feas)
    std::memcpy(out_feas, feas, static_cast<size_t>(Gp) * Np);
  if (out_consf)
    std::memcpy(out_consf, consf,
                static_cast<size_t>(Gp) * C * sizeof(int32_t));
  return 0;
}
