"""Web UI: hash-routed single-page app, no build step, no dependencies.

Reference: ui/ — a full Ember app consuming /v1/* with live updates
(routes/adapters per resource, ui/app/router.js).  This build serves
one HTML page at /ui with the same route structure in miniature:

  #/            dashboard (jobs / deployments / nodes / services)
  #/job/<id>    job detail: groups, allocations, evals, deployments,
                versions
  #/node/<id>   node detail: attributes, drivers, allocations on node
  #/alloc/<id>  alloc detail: task states + events, log tail (when the
                alloc runs on this agent's node)

Everything renders from the same /v1 endpoints the CLI and SDK use,
auto-refreshing every 2s; all interpolated values are HTML-escaped.

The counterpart of `nomad_tpu.api.ui`.  The alloc page's log tail reads
`/v1/client/fs/logs/`, which an agent with a node agent serves (or
forwards to the alloc's owning agent).
"""

UI_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>nomad-tpu</title>
<style>
  body { font: 13px/1.5 system-ui, sans-serif; margin: 0; color: #222; }
  header { background: #1f2d3d; color: #fff; padding: 10px 20px; }
  header h1 { font-size: 16px; margin: 0; display: inline-block; }
  header h1 a { color: #fff; text-decoration: none; }
  header span { opacity: .7; margin-left: 12px; font-size: 12px; }
  main { padding: 16px 20px; max-width: 1100px; }
  h2 { font-size: 14px; border-bottom: 1px solid #ddd;
       padding-bottom: 4px; margin: 22px 0 8px; }
  table { border-collapse: collapse; width: 100%; }
  th, td { text-align: left; padding: 4px 10px 4px 0;
           border-bottom: 1px solid #f0f0f0; font-size: 12.5px; }
  th { color: #888; font-weight: 600; }
  .ok { color: #1a7f37; } .bad { color: #c62828; }
  .dim { color: #999; }
  code { background: #f5f5f5; padding: 1px 4px; border-radius: 3px; }
  a { color: #14508c; text-decoration: none; }
  a:hover { text-decoration: underline; }
  pre.logs { background: #111; color: #ddd; padding: 10px;
             max-height: 320px; overflow: auto; font-size: 12px; }
  .crumb { margin: 0 0 10px; font-size: 12.5px; }
</style>
</head>
<body>
<header><h1><a href="#/">nomad-tpu</a></h1><span id="stamp"></span>
</header>
<main id="view"></main>
<script>
async function j(path) {
  const r = await fetch(path);
  if (!r.ok) throw new Error(path + ": " + r.status);
  return r.json();
}
function esc(v) {
  return String(v ?? "").replace(/[&<>"']/g, c => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;",
    '"': "&quot;", "'": "&#39;"}[c]));
}
function row(cells, header) {
  const tag = header ? "th" : "td";
  return "<tr>" + cells.map(c => `<${tag}>${c}</${tag}>`).join("") +
         "</tr>";
}
function table(header, rows) {
  return "<table>" + row(header, true) +
    (rows.length ? rows.map(r => row(r)).join("")
                 : row(["<span class=dim>none</span>"])) + "</table>";
}
function statusCell(s, goodSet) {
  const cls = goodSet.includes(s) ? "ok" : "bad";
  return `<span class="${cls}">${esc(s)}</span>`;
}
function idLink(kind, id, len) {
  return `<a href="#/${kind}/${encodeURIComponent(id)}"><code>` +
         esc(len ? id.slice(0, len) : id) + "</code></a>";
}

async function viewDashboard() {
  const [jobs, nodes, deps, services] = await Promise.all([
    j("/v1/jobs"), j("/v1/nodes"), j("/v1/deployments"),
    j("/v1/services")]);
  return "<h2>Jobs</h2>" +
    table(["ID", "Type", "Priority", "Status", "Summary"],
      jobs.map(x => [
        idLink("job", x.id), esc(x.type), esc(x.priority),
        statusCell(x.status, ["running"]), esc(x.summary || "")])) +
    "<h2>Deployments</h2>" +
    table(["ID", "Job", "Status", "Description"],
      deps.map(d => [
        `<code>${esc(d.id.slice(0, 8))}</code>`,
        idLink("job", d.job_id),
        statusCell(d.status, ["successful", "running"]),
        esc(d.status_description || "")])) +
    "<h2>Nodes</h2>" +
    table(["ID", "Name", "DC", "Class", "Eligibility", "Status"],
      nodes.map(n => [
        idLink("node", n.id, 8), esc(n.name), esc(n.datacenter),
        n.node_class ? esc(n.node_class) : "<span class=dim>-</span>",
        esc(n.scheduling_eligibility),
        statusCell(n.status, ["ready"])])) +
    "<h2>Services</h2>" +
    table(["Service", "Tags"],
      services.map(s => [
        `<code>${esc(s.ServiceName)}</code>`,
        esc((s.Tags || []).join(", "))]));
}

function allocRows(allocs) {
  // alloc LIST endpoints return CamelCase stubs (the reference's
  // AllocListStub JSON); detail endpoints are snake_case
  return allocs.map(a => [
    idLink("alloc", a.ID, 8), esc(a.TaskGroup), esc(a.Name),
    a.NodeID ? idLink("node", a.NodeID, 8)
             : "<span class=dim>-</span>",
    esc(a.DesiredStatus),
    statusCell(a.ClientStatus, ["running", "complete"])]);
}
const ALLOC_HDR = ["ID", "Group", "Name", "Node", "Desired", "Client"];

async function viewJob(id) {
  const q = encodeURIComponent(id);   // dispatched child ids embed '/'
  const [job, allocs, evals, deps, versions] = await Promise.all([
    j(`/v1/job/${q}`), j(`/v1/job/${q}/allocations`),
    j(`/v1/job/${q}/evaluations`), j(`/v1/job/${q}/deployments`),
    j(`/v1/job/${q}/versions`).catch(() => [])]);
  const groups = (job.task_groups || []).map(g => [
    esc(g.name), esc(g.count),
    esc((g.tasks || []).map(t => t.name + " (" + t.driver + ")")
        .join(", "))]);
  return `<p class=crumb><a href="#/">jobs</a> /
            <code>${esc(id)}</code></p>` +
    `<h2>Job ${esc(id)} <span class=dim>type=${esc(job.type)}
       priority=${esc(job.priority)}
       status=${esc(job.status)}</span></h2>` +
    "<h2>Task groups</h2>" +
    table(["Group", "Count", "Tasks"], groups) +
    "<h2>Allocations</h2>" + table(ALLOC_HDR, allocRows(allocs)) +
    "<h2>Evaluations</h2>" +
    table(["ID", "Trigger", "Status"],
      evals.map(e => [`<code>${esc(e.id.slice(0, 8))}</code>`,
                      esc(e.triggered_by),
                      statusCell(e.status, ["complete"])])) +
    "<h2>Deployments</h2>" +
    table(["ID", "Status", "Description"],
      deps.map(d => [`<code>${esc(d.id.slice(0, 8))}</code>`,
                     statusCell(d.status, ["successful", "running"]),
                     esc(d.status_description || "")])) +
    "<h2>Versions</h2>" +
    table(["Version", "Stable"],
      versions.map(v => [esc(v.version), esc(v.stable)]));
}

async function viewNode(id) {
  const [node, allocs] = await Promise.all([
    j(`/v1/node/${id}`), j(`/v1/node/${id}/allocations`)]);
  const attrs = Object.entries(node.attributes || {}).sort()
    .map(([k, v]) => [`<code>${esc(k)}</code>`, esc(v)]);
  return `<p class=crumb><a href="#/">nodes</a> /
            <code>${esc(node.name)}</code></p>` +
    `<h2>Node ${esc(node.name)}
       <span class=dim>${esc(node.id)} dc=${esc(node.datacenter)}
       status=${esc(node.status)}
       eligibility=${esc(node.scheduling_eligibility)}</span></h2>` +
    "<h2>Allocations on node</h2>" +
    table(ALLOC_HDR, allocRows(allocs)) +
    "<h2>Attributes</h2>" + table(["Attribute", "Value"], attrs);
}

async function viewAlloc(id) {
  const a = await j(`/v1/allocation/${id}`);
  const states = Object.entries(a.task_states || {}).map(([t, st]) => [
    esc(t), statusCell(st.state, ["running", "dead"]),
    esc(st.failed ? "failed" : ""),
    esc((st.events || []).map(e => e.type).join(" \\u2192 "))]);
  const events = [];
  for (const [t, st] of Object.entries(a.task_states || {}))
    for (const e of (st.events || []))
      events.push([esc(t), esc(e.type),
                   esc(e.display_message || e.message || "")]);
  let logs = "";
  const tasks = Object.keys(a.task_states || {});
  if (tasks.length) {
    try {
      const lg = await j(`/v1/client/fs/logs/${id}` +
                         `?task=${encodeURIComponent(tasks[0])}` +
                         `&type=stdout&tail_lines=40`);
      logs = `<h2>Logs <span class=dim>${esc(tasks[0])}
              stdout (tail)</span></h2>` +
             `<pre class=logs>${esc(lg.data || "")}</pre>`;
    } catch (e) { /* alloc not on this agent's node */ }
  }
  return `<p class=crumb><a href="#/">allocs</a> /
            <a href="#/job/${encodeURIComponent(a.job_id)}">` +
            `${esc(a.job_id)}</a> /
            <code>${esc(a.id.slice(0, 8))}</code></p>` +
    `<h2>Allocation ${esc(a.name)}
       <span class=dim>${esc(a.id)}
       desired=${esc(a.desired_status)}
       client=${esc(a.client_status)}</span></h2>` +
    "<h2>Task states</h2>" +
    table(["Task", "State", "Failed", "Events"], states) +
    "<h2>Events</h2>" +
    table(["Task", "Type", "Message"], events) + logs;
}

async function render() {
  const h = location.hash || "#/";
  const parts = h.slice(2).split("/");
  let html;
  try {
    if (parts[0] === "job" && parts[1])
      html = await viewJob(decodeURIComponent(parts[1]));
    else if (parts[0] === "node" && parts[1])
      html = await viewNode(decodeURIComponent(parts[1]));
    else if (parts[0] === "alloc" && parts[1])
      html = await viewAlloc(decodeURIComponent(parts[1]));
    else
      html = await viewDashboard();
    document.getElementById("view").innerHTML = html;
    document.getElementById("stamp").textContent =
      "updated " + new Date().toLocaleTimeString();
  } catch (e) {
    document.getElementById("stamp").textContent = "error: " + e;
  }
}
window.addEventListener("hashchange", render);
render();
setInterval(render, 2000);
</script>
</body>
</html>
"""
