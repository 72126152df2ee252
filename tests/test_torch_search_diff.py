"""The port's prefix search (`nomad_tpu_torch.server.search`) and field-
level job diff (`nomad_tpu_torch.structs.diff`) against the JAX
package's, on the CPU.

Each case of `tests/test_search_diff.py` runs on both packages (`pkg` =
"ref" / "port") with each package's own mock and store, the jobs built
with fixed ids; the port's outcome — the search matches and truncation
flags, and `job_diff`'s output as wire JSON — must equal the
reference's."""
import copy
import json
import urllib.request

import pytest

from tests.test_torch_http_api import PKG_NAMES, Outcomes


def mk_job(P, jid="job-1"):
    j = P.mock.job()
    j.id = j.name = jid
    return j


def seeded_store(P):
    st = P.StateStore()
    ix = 0
    for i in range(3):
        ix += 1
        st.upsert_job(ix, mk_job(P, f"web-{i}"))
    n = P.mock.node()
    n.id = "aaaa-node"
    ix += 1
    st.upsert_node(ix, n)
    return st


def wire(d):
    return json.loads(json.dumps(d, sort_keys=True))


def case_search_prefix_and_contexts(P):
    st = seeded_store(P)
    matches, trunc = P.search.search(st, "web-")
    assert matches["jobs"] == ["web-0", "web-1", "web-2"]
    assert matches["nodes"] == [] and not trunc["jobs"]
    nodes, _ = P.search.search(st, "aaaa", context="nodes")
    assert nodes == {"nodes": ["aaaa-node"]}
    return matches, trunc, nodes


def case_search_truncates_per_context(P):
    st = P.StateStore()
    for i in range(P.search.TRUNCATE_LIMIT + 5):
        st.upsert_job(i + 1, mk_job(P, f"batch-{i:03}"))
    matches, trunc = P.search.search(st, "batch-", context="jobs")
    assert len(matches["jobs"]) == P.search.TRUNCATE_LIMIT
    assert trunc["jobs"]
    return matches, trunc


def case_job_diff_none_for_identical(P):
    j = mk_job(P)
    d = P.diff.job_diff(j, copy.deepcopy(j))
    assert d["Type"] == P.diff.DIFF_NONE
    return wire(d)


def case_job_diff_added_job(P):
    d = P.diff.job_diff(None, mk_job(P))
    assert d["Type"] == P.diff.DIFF_ADDED
    assert d["TaskGroups"] and d["TaskGroups"][0]["Type"] == \
        P.diff.DIFF_ADDED
    return wire(d)


def case_job_diff_edited_fields_and_tasks(P):
    old = mk_job(P)
    new = copy.deepcopy(old)
    new.priority = old.priority + 10
    new.task_groups[0].count = old.task_groups[0].count + 2
    new.task_groups[0].tasks[0].resources.cpu += 500
    d = P.diff.job_diff(old, new)
    assert d["Type"] == P.diff.DIFF_EDITED
    assert any(f["Name"] == "priority" and f["Type"] == P.diff.DIFF_EDITED
               for f in d["Fields"])
    tg = d["TaskGroups"][0]
    assert any(f["Name"] == "count" for f in tg["Fields"])
    res = next(o for o in tg["Tasks"][0]["Objects"]
               if o["Name"] == "Resources")
    assert any(f["Name"] == "cpu" for f in res["Fields"])
    return wire(d)


def case_job_diff_task_added_and_deleted(P):
    old = mk_job(P)
    new = copy.deepcopy(old)
    extra = copy.deepcopy(new.task_groups[0].tasks[0])
    extra.name = "sidecar"
    new.task_groups[0].tasks.append(extra)
    d = P.diff.job_diff(old, new)
    tasks = d["TaskGroups"][0]["Tasks"]
    assert [t["Name"] for t in tasks] == ["sidecar"]
    assert tasks[0]["Type"] == P.diff.DIFF_ADDED
    d2 = P.diff.job_diff(new, old)
    assert d2["TaskGroups"][0]["Tasks"][0]["Type"] == P.diff.DIFF_DELETED
    return wire(d), wire(d2)


def case_job_diff_constraint_set_changes(P):
    old = mk_job(P)
    new = copy.deepcopy(old)
    new.constraints = list(new.constraints) + [
        P.structs.Constraint("${attr.rack}", "r1", "=")]
    d = P.diff.job_diff(old, new)
    cons = [o for o in d["Objects"] if o["Name"] == "Constraint"]
    assert len(cons) == 1 and cons[0]["Type"] == P.diff.DIFF_ADDED
    return wire(d)


def case_http_search_and_plan_diff(P):
    srv = P.Server(num_workers=0)
    srv.start()
    http = P.http_server.HTTPAgentServer(srv)
    http.start()
    try:
        job = mk_job(P, "web-search")
        srv.register_job(job)

        def post(path, body):
            req = urllib.request.Request(
                http.address + path, method="POST",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as r:
                return json.loads(r.read())

        found = post("/v1/search", {"prefix": "web-", "context": "jobs"})
        assert job.id in found["matches"]["jobs"]
        new = copy.deepcopy(job)
        new.task_groups[0].count += 1
        out = post(f"/v1/job/{job.id}/plan",
                   {"job": P.codec.to_wire(new), "diff": True})
        assert out["diff"]["Type"] == P.diff.DIFF_EDITED
        assert any(f["Name"] == "count"
                   for f in out["diff"]["TaskGroups"][0]["Fields"])
        return found, out["diff"], out["annotations"]
    finally:
        http.stop()
        srv.stop()


OUTCOMES = Outcomes({
    "search_prefix_and_contexts": case_search_prefix_and_contexts,
    "search_truncates_per_context": case_search_truncates_per_context,
    "job_diff_none_for_identical": case_job_diff_none_for_identical,
    "job_diff_added_job": case_job_diff_added_job,
    "job_diff_edited_fields_and_tasks":
        case_job_diff_edited_fields_and_tasks,
    "job_diff_task_added_and_deleted": case_job_diff_task_added_and_deleted,
    "job_diff_constraint_set_changes": case_job_diff_constraint_set_changes,
    "http_search_and_plan_diff": case_http_search_and_plan_diff,
})


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_search_prefix_and_contexts(pkg):
    OUTCOMES.check("search_prefix_and_contexts", pkg)


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_search_truncates_per_context(pkg):
    OUTCOMES.check("search_truncates_per_context", pkg)


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_job_diff_none_for_identical(pkg):
    OUTCOMES.check("job_diff_none_for_identical", pkg)


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_job_diff_added_job(pkg):
    OUTCOMES.check("job_diff_added_job", pkg)


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_job_diff_edited_fields_and_tasks(pkg):
    OUTCOMES.check("job_diff_edited_fields_and_tasks", pkg)


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_job_diff_task_added_and_deleted(pkg):
    OUTCOMES.check("job_diff_task_added_and_deleted", pkg)


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_job_diff_constraint_set_changes(pkg):
    OUTCOMES.check("job_diff_constraint_set_changes", pkg)


@pytest.mark.parametrize("pkg", PKG_NAMES)
def test_http_search_and_plan_diff(pkg):
    OUTCOMES.check("http_search_and_plan_diff", pkg)
