"""Dashboard web UI: one self-contained page over the REST API.

The port's copy of ``ray_tpu/dashboard/ui.py``.  The utilization sparkline
reads the reporter's ``tpu_mem_percent`` (``dashboard/reporter.py`` keeps
the JAX package's sample keys), which on this package holds the CUDA
card's memory in use; the page labels it ``gpu mem``.

Parity role: the reference's React dashboard (``dashboard/client/src``,
21.9k LoC TS) — cluster/resource overview, node list, job list, serve
applications, task/actor summaries, recent events. Here it is a single
dependency-free HTML document (no build step, no npm, works air-gapped)
that polls the same REST endpoints the CLI uses.
"""

INDEX_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>ray_tpu_torch dashboard</title>
<style>
  :root { color-scheme: light dark; }
  body { font: 13px/1.5 system-ui, sans-serif; margin: 0; background: #0f1419; color: #d6dbe1; }
  header { padding: 14px 22px; background: #161c24; border-bottom: 1px solid #2a323d;
           display: flex; align-items: baseline; gap: 16px; }
  header h1 { font-size: 16px; margin: 0; color: #7fd1b9; }
  header span { color: #8a94a0; font-size: 12px; }
  main { padding: 18px 22px; display: grid; gap: 18px;
         grid-template-columns: repeat(auto-fit, minmax(340px, 1fr)); }
  section { background: #161c24; border: 1px solid #2a323d; border-radius: 8px; padding: 14px 16px; }
  h2 { font-size: 13px; margin: 0 0 10px; color: #9fb3c8; text-transform: uppercase;
       letter-spacing: .06em; }
  table { border-collapse: collapse; width: 100%; }
  th, td { text-align: left; padding: 3px 10px 3px 0; font-variant-numeric: tabular-nums; }
  th { color: #8a94a0; font-weight: 500; border-bottom: 1px solid #2a323d; }
  .bar { height: 8px; background: #2a323d; border-radius: 4px; overflow: hidden; min-width: 90px; }
  .bar i { display: block; height: 100%; background: #7fd1b9; }
  .num { color: #e8c268; }
  .ok { color: #7fd1b9; } .bad { color: #e07a5f; }
  pre { margin: 0; white-space: pre-wrap; word-break: break-all; font-size: 11px; color: #8a94a0; }
</style>
</head>
<body>
<header>
  <h1>ray_tpu_torch</h1>
  <span id="version"></span>
  <span id="updated"></span>
</header>
<main>
  <section><h2>Resources</h2><table id="resources"></table></section>
  <section style="grid-column: 1 / -1"><h2>Nodes</h2><table id="nodes"></table></section>
  <section><h2>Work</h2><table id="work"></table></section>
  <section><h2>Jobs</h2><table id="jobs"></table></section>
  <section><h2>Serve</h2><table id="serve"></table>
    <table id="servetopo" style="margin-top:8px"></table></section>
  <section style="grid-column: 1 / -1"><h2>Actors</h2><table id="actors"></table></section>
  <section style="grid-column: 1 / -1"><h2>Recent tasks</h2><table id="tasks"></table></section>
  <section style="grid-column: 1 / -1; display:none" id="detailsec"><h2 id="detailtitle">Detail</h2>
    <table id="detailkv"></table><table id="detailevents" style="margin-top:8px"></table></section>
  <section><h2>Placement groups</h2><table id="pgs"></table></section>
  <section style="grid-column: 1 / -1"><h2>Object memory</h2>
    <table id="memnodes"></table><table id="memtop" style="margin-top:8px"></table></section>
  <section style="grid-column: 1 / -1"><h2>Data-plane transfers</h2><table id="transfers"></table></section>
  <section style="grid-column: 1 / -1"><h2>Dataset executions</h2><table id="datasets"></table></section>
  <section style="grid-column: 1 / -1"><h2>Cluster throughput</h2><div id="clusterrates"></div></section>
  <section style="grid-column: 1 / -1"><h2>Node utilization</h2><div id="util"></div></section>
  <section style="grid-column: 1 / -1"><h2>Node logs</h2>
    <div style="margin-bottom:8px">node: <select id="lognode" style="background:#0f1419;color:#d6dbe1;border:1px solid #2a323d"></select>
      &nbsp; search all nodes: <input id="logq" placeholder="regex" style="background:#0f1419;color:#d6dbe1;border:1px solid #2a323d;width:220px">
      <button onclick="searchLogs()" style="background:#2a323d;color:#d6dbe1;border:0;padding:2px 10px;cursor:pointer">grep</button></div>
    <pre id="logsearch" style="max-height:200px;overflow:auto"></pre>
    <pre id="nodelogs" style="max-height:260px;overflow:auto"></pre>
  </section>
  <section style="grid-column: 1 / -1"><h2>Task timeline</h2>
    <div style="margin-bottom:6px">window:
      <select id="tlwin" style="background:#0f1419;color:#d6dbe1;border:1px solid #2a323d">
        <option value="30">30s</option><option value="120" selected>2m</option>
        <option value="600">10m</option></select></div>
    <div id="timeline" style="overflow-x:auto"></div>
  </section>
  <section style="grid-column: 1 / -1"><h2>Recent events</h2><pre id="events"></pre>
    <p style="margin:8px 0 0"><a style="color:#7fd1b9" href="/api/timeline" download="timeline.json">download chrome timeline</a></p>
  </section>
</main>
<script>
const $ = id => document.getElementById(id);
const get = p => fetch(p).then(r => r.json()).catch(() => null);
const esc = v => String(v).replace(/[&<>"']/g,
  c => ({"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;"}[c]));
function rows(el, header, data) {
  el.innerHTML = "<tr>" + header.map(h => `<th>${h}</th>`).join("") + "</tr>" +
    data.map(r => "<tr>" + r.map(c => `<td>${c}</td>`).join("") + "</tr>").join("");
}
function bar(used, total) {
  const pct = total ? Math.min(100, 100 * used / total) : 0;
  return `<div class="bar"><i style="width:${pct}%"></i></div>`;
}
async function refresh() {
  const [ver, status, nodes, jobs, serve, events, tasks, actors, objects, taskList, actorList] = await Promise.all([
    get("/api/version"), get("/api/cluster_status"), get("/api/nodes"), get("/api/jobs"),
    get("/api/serve/applications"), get("/api/events?limit=12"),
    get("/api/summary/tasks"), get("/api/summary/actors"), get("/api/objects?limit=1"),
    get("/api/tasks?limit=12"), get("/api/actors?limit=12"),
  ]);
  if (ver) $("version").textContent = "v" + ver.version + " · " + ver.session_dir;
  $("updated").textContent = "updated " + new Date().toLocaleTimeString();
  if (status) {
    const data = Object.keys(status.resources_total || {}).sort().map(k => {
      const total = status.resources_total[k], avail = (status.resources_available || {})[k] ?? 0;
      const used = total - avail;
      return [esc(k), `<span class="num">${used.toFixed(1)} / ${total.toFixed(1)}</span>`, bar(used, total)];
    });
    rows($("resources"), ["resource", "used", ""], data);
  }
  if (nodes) rows($("nodes"), ["node", "state", "address", "cpu", "", "labels", "head"],
    nodes.nodes.map(n => {
      const tot = (n.resources_total || {})["CPU"] ?? 0;
      const avail = (n.resources_available || {})["CPU"] ?? 0;
      const used = tot - avail;
      return [`<a style="color:#7fd1b9;cursor:pointer" onclick="showNodeDetail('${esc(n.node_id)}')">${esc(n.node_id.slice(0, 12))}</a>`,
        `<span class="${n.state === 'ALIVE' ? 'ok' : 'bad'}">${esc(n.state)}</span>`,
        esc(n.address || ""),
        `<span class="num">${used.toFixed(1)}/${tot.toFixed(1)}</span>`, bar(used, tot),
        esc(Object.entries(n.labels || {}).map(([k, v]) => k + "=" + v).join(" ").slice(0, 40)),
        n.is_head ? "★" : ""];
    }));
  if (actorList) rows($("actors"), ["actor", "class", "name", "state", "node", "restarts"],
    (actorList.actors || []).slice(0, 12).map(a => [
      `<a style="color:#7fd1b9;cursor:pointer" onclick="showDetail('actors','${esc(a.actor_id)}')">${esc(a.actor_id.slice(0, 12))}</a>`,
      esc(a.class_name), esc(a.name),
      `<span class="${a.state === 'ALIVE' ? 'ok' : a.state === 'DEAD' ? 'bad' : ''}">${esc(a.state)}</span>`,
      esc((a.node_id || "").slice(0, 12)), esc(a.restarts + "/" + a.max_restarts)]));
  if (taskList) rows($("tasks"), ["task", "name", "state", "node", "attempt", "duration"],
    (taskList.tasks || []).slice(-12).reverse().map(taskRow));
  const work = [];
  if (status) work.push(["pending tasks", `<span class="num">${status.pending_tasks}</span>`]);
  if (tasks) work.push(["tasks total", `<span class="num">${tasks.total_tasks ?? 0}</span>`]);
  if (tasks) for (const [name, info] of Object.entries(tasks.summary || {}))
    work.push(["task " + esc(name), esc(JSON.stringify(info.state_counts))]);
  if (actors) work.push(["actors total", `<span class="num">${actors.total_actors ?? 0}</span>`]);
  if (actors) for (const [name, info] of Object.entries(actors.summary || {}))
    work.push(["actor " + esc(name), esc(JSON.stringify(info.state_counts ?? info))]);
  rows($("work"), ["metric", "count"], work.slice(0, 14));
  if (jobs) rows($("jobs"), ["job", "status", "entrypoint"],
    (jobs.jobs || []).slice(-8).reverse().map(j => [esc(j.submission_id?.slice(0, 14) ?? "-"),
      `<span class="${j.status === 'SUCCEEDED' ? 'ok' : j.status === 'FAILED' ? 'bad' : ''}">${esc(j.status)}</span>`,
      esc((j.entrypoint || "").slice(0, 42))]));
  if (serve) {
    // application topology: deployment DAG per app, ingress marked,
    // upstream dependencies as arrows; re-rendered every refresh so a
    // shutdown app leaves the screen
    const topo = Object.entries(serve.applications || {}).map(([app, t]) =>
      (t.deployments || []).map(d => {
        const up = (d.depends_on || []).length ? ` ← ${d.depends_on.map(esc).join(", ")}` : "";
        const ing = d.name === t.ingress ? " ★" : "";
        return `<tr><td>${esc(app)}</td><td>${esc(d.name)}${ing}</td><td>${esc(d.num_replicas)}</td><td>${up}</td></tr>`;
      }).join("")
    ).join("");
    $("servetopo").innerHTML = topo
      ? "<tr><th>app</th><th>deployment (★ ingress)</th><th>replicas</th><th>depends on</th></tr>" + topo
      : "";
  }
  if (serve) rows($("serve"), ["deployment", "replicas", "target"],
    Object.entries(serve.deployments || {}).map(([name, d]) =>
      [esc(name), esc(d.num_replicas), esc(d.target_replicas)]));
  if (events) $("events").textContent =
    (events.events || []).map(e => `${e.timestamp ?? ""} [${e.severity ?? e.level ?? ""}] ${e.label ?? ""} ${e.message ?? ""}`).join("\\n") || "(none)";
  await refreshUtil();
  await refreshClusterRates();
  await refreshLogs();
  await refreshTransfers();
  await refreshMemory();
  await refreshTimeline();
}
async function refreshMemory() {
  const pgs = await get("/api/placement_groups");
  if (pgs) rows($("pgs"), ["pg", "name", "state", "strategy", "bundles"],
    (pgs.placement_groups || []).slice(0, 10).map(p => [
      esc((p.placement_group_id || "").slice(0, 12)), esc(p.name || ""),
      `<span class="${p.state === 'CREATED' ? 'ok' : ''}">${esc(p.state || "")}</span>`,
      esc(p.strategy || ""), esc((p.bundles || []).length)]));
  const mem = await get("/api/memory");
  if (!mem) return;
  rows($("memnodes"), ["node", "objects", "bytes", "by tier", "shm arena"],
    Object.entries(mem.nodes || {}).map(([node, n]) => {
      const arena = (mem.arenas || {})[node];
      return [esc(node.slice(0, 12)), `<span class="num">${n.count}</span>`,
        `<span class="num">${fmtBytes(n.bytes)}</span>`,
        esc(Object.entries(n.tiers || {}).map(([t, v]) => `${t}:${v.count}`).join(" ")),
        arena ? `<span class="num">${fmtBytes(arena.used)}</span> / ${fmtBytes(arena.capacity)} ${bar(arena.used, arena.capacity)}` : ""];
    }));
  rows($("memtop"), ["largest objects", "node", "tier", "size", "refs"],
    (mem.top_objects || []).slice(0, 10).map(o => [
      esc((o.object_id || "").slice(0, 16)), esc((o.node_id || "").slice(0, 12)),
      esc(o.tier || ""), `<span class="num">${fmtBytes(o.size_bytes)}</span>`,
      esc(o.ref_count == null ? "" : JSON.stringify(o.ref_count))]));
}
function fmtBytes(n) {
  if (n == null) return "";
  if (n >= 1e9) return (n / 1e9).toFixed(2) + " GB";
  if (n >= 1e6) return (n / 1e6).toFixed(1) + " MB";
  if (n >= 1e3) return (n / 1e3).toFixed(1) + " KB";
  return n + " B";
}
async function refreshTransfers() {
  const t = await get("/api/transfers");
  if (!t) return;
  const data = Object.entries(t.nodes || {}).map(([node, s]) => {
    const srv = s.data_server || {}, cli = s.data_client || {}, dev = s.device || {};
    return [esc(node.slice(0, 12)),
      `<span class="num">${(srv.pulls_served ?? 0)}/${(cli.pulls_issued ?? 0)}</span>`,
      `<span class="num">${(srv.pushes_received ?? 0)}/${(cli.pushes_sent ?? 0)}</span>`,
      `<span class="num">${fmtBytes((srv.bytes_sent ?? 0) + (cli.bytes_sent ?? 0))}</span>`,
      `<span class="num">${fmtBytes((srv.bytes_received ?? 0) + (cli.bytes_received ?? 0))}</span>`,
      `<span class="num">${dev.arrays_packed ?? 0}/${dev.arrays_restored ?? 0}</span>`,
      `<span class="num">${dev.ici_pulls ?? 0}</span>`];
  });
  rows($("transfers"),
    ["node", "pulls srv/iss", "pushes in/out", "bytes out", "bytes in", "dev pack/restore", "ici pulls"],
    data.length ? data : [["(no transfer activity yet)", "", "", "", "", "", ""]]);
  const dsets = await get("/api/data/datasets");
  if (dsets) rows($("datasets"), ["pipeline", "when", "wall", "ops", "rows", "bytes"],
    (dsets.executions || []).slice(-8).reverse().map(e => {
      const last = e.ops[e.ops.length - 1] || {};
      return [esc(e.name.slice(0, 48)), new Date(e.ts * 1000).toLocaleTimeString(),
        `<span class="num">${e.wall_s.toFixed(2)}s</span>`, esc(e.ops.length),
        `<span class="num">${last.rows_out ?? 0}</span>`,
        `<span class="num">${fmtBytes(last.bytes_out)}</span>`];
    }));
}
async function showNodeDetail(nodeId) {
  // per-node drill-down: identity + its actors/tasks + utilization tail
  const [nodes, actors, tasks, hist, logs] = await Promise.all([
    get("/api/nodes"), get("/api/actors?limit=1000"), get("/api/tasks?limit=1000"),
    get(`/api/nodes/${nodeId}/metrics?minutes=1`), get(`/api/nodes/${nodeId}/logs?lines=6`),
  ]);
  const n = ((nodes || {}).nodes || []).find(x => x.node_id === nodeId);
  if (!n) return;
  $("detailsec").style.display = "";
  $("detailtitle").textContent = "Node " + nodeId.slice(0, 16) + (n.is_head ? " ★head" : "");
  const myActors = ((actors || {}).actors || []).filter(a => a.node_id === nodeId);
  const myTasks = ((tasks || {}).tasks || []).filter(t => t.node_id === nodeId);
  const kv = [
    ["state", esc(n.state)], ["address", esc(n.address || "(in-process)")],
    ["resources", esc(JSON.stringify(n.resources_total))],
    ["available", esc(JSON.stringify(n.resources_available))],
    ["labels", esc(JSON.stringify(n.labels || {}))],
    ["actors here", `<span class="num">${myActors.length}</span> ` +
      esc(myActors.slice(0, 8).map(a => a.class_name).join(", "))],
    ["recent tasks here", `<span class="num">${myTasks.length}</span>`],
  ];
  const pts = ((hist || {}).series) || [];
  if (pts.length) kv.push(["cpu now", `<span class="num">${(pts[pts.length-1].cpu_percent ?? 0).toFixed(0)}%</span>`]);
  if (logs && (logs.lines || []).length)
    kv.push(["log tail", `<pre style="margin:0">${esc(logs.lines.join("\\n"))}</pre>`]);
  rows($("detailkv"), ["field", "value"], kv);
  rows($("detailevents"), ["task", "name", "state", "node", "attempt", "duration"],
    myTasks.slice(-20).reverse().map(taskRow));
  $("detailsec").scrollIntoView({behavior: "smooth"});
}
function taskRow(t) {
  // the one task-row formatter: main table, task detail, node drill-down
  return [
    `<a style="color:#7fd1b9;cursor:pointer" onclick="showDetail('tasks','${esc(t.task_id || "")}')">${esc((t.task_id || "").slice(0, 12))}</a>`,
    esc(t.name || ""),
    `<span class="${t.state === 'FINISHED' ? 'ok' : t.state === 'FAILED' ? 'bad' : ''}">${esc(t.state || "")}</span>`,
    esc((t.node_id || "").slice(0, 12)), esc(t.attempt ?? 0),
    t.duration_s == null ? "" : `<span class="num">${(+t.duration_s).toFixed(3)}s</span>`];
}
async function showDetail(kind, id) {
  const d = await get(`/api/${kind}/${id}`);
  if (!d) return;
  $("detailsec").style.display = "";
  $("detailtitle").textContent = (kind === "actors" ? "Actor " : "Task ") + id.slice(0, 16);
  const kv = Object.entries(d).filter(([k]) => k !== "events")
    .map(([k, v]) => [esc(k), `<span class="num">${esc(JSON.stringify(v))}</span>`]);
  rows($("detailkv"), ["field", "value"], kv);
  const evs = (d.events || []).slice(-30).reverse().map(e => [
    esc((e.task_id || "").slice(0, 12)), esc(e.name || ""), esc(e.state || ""),
    esc(e.node || ""), esc(e.attempt ?? 0),
    e.start_ts && e.ts ? `<span class="num">${(e.ts - e.start_ts).toFixed(3)}s</span>` : ""]);
  rows($("detailevents"), ["task", "name", "state", "node", "attempt", "duration"], evs);
  $("detailsec").scrollIntoView({behavior: "smooth"});
}
function spark(points, key, color) {
  const w = 260, h = 36;
  const vals = points.map(p => p[key]).filter(v => v != null);
  if (!vals.length) return "<span style='color:#555'>no data</span>";
  const max = Math.max(100, ...vals);
  const step = vals.length > 1 ? w / (vals.length - 1) : w;
  const pts = vals.map((v, i) => `${(i * step).toFixed(1)},${(h - h * v / max).toFixed(1)}`).join(" ");
  const last = vals[vals.length - 1];
  return `<svg width="${w}" height="${h}" style="vertical-align:middle">
    <polyline points="${pts}" fill="none" stroke="${color}" stroke-width="1.5"/></svg>
    <span class="num" style="margin-left:6px">${last.toFixed(1)}%</span>`;
}
function fmtRate(v, unit) {
  if (unit === "B/s") {
    if (v >= 1e9) return (v / 1e9).toFixed(2) + " GB/s";
    if (v >= 1e6) return (v / 1e6).toFixed(1) + " MB/s";
    if (v >= 1e3) return (v / 1e3).toFixed(1) + " KB/s";
  }
  return v >= 1000 ? (v / 1000).toFixed(1) + "k" + unit.replace("B/s", "/s") : v.toFixed(1) + " " + unit;
}
function sparkRate(points, key, color, unit) {
  const w = 260, h = 36;
  const vals = points.map(p => p[key]).filter(v => v != null);
  if (!vals.length) return "<span style='color:#555'>no data</span>";
  const max = Math.max(1e-9, ...vals);
  const step = vals.length > 1 ? w / (vals.length - 1) : w;
  const pts = vals.map((v, i) => `${(i * step).toFixed(1)},${(h - h * v / max).toFixed(1)}`).join(" ");
  return `<svg width="${w}" height="${h}" style="vertical-align:middle">
    <polyline points="${pts}" fill="none" stroke="${color}" stroke-width="1.5"/></svg>
    <span class="num" style="margin-left:6px">${fmtRate(vals[vals.length - 1], unit)}</span>`;
}
async function refreshClusterRates() {
  const hist = await get("/api/metrics/cluster_history?minutes=15");
  if (!hist || !(hist.points || []).length) { $("clusterrates").innerHTML = "(no samples yet)"; return; }
  $("clusterrates").innerHTML = `<table><tr>
    <td>tasks/s ${sparkRate(hist.points, "tasks_per_s", "#7fd1b9", "/s")}</td>
    <td>transfer ${sparkRate(hist.points, "transfer_bytes_per_s", "#e8c268", "B/s")}</td></tr></table>`;
}
async function refreshTimeline() {
  // inline Gantt over the chrome-trace events: lanes = node/worker pairs
  // (busiest first), bars = task spans colored by final state
  const win = +$("tlwin").value;
  const trace = await get(`/api/timeline?since_s=${win}&limit=400`);
  if (!trace || !trace.length) { $("timeline").innerHTML = "(no finished tasks in window)"; return; }
  // anchor the axis to the wall clock (same host as the server), matching
  // the server-side window — anchoring to the newest span would mislabel
  // the axis after idle periods
  const end = Date.now() * 1e3;
  const start = end - win * 1e6;
  const lanes = new Map();
  for (const e of trace) {
    const key = `${e.pid} ${e.tid}`;
    if (!lanes.has(key)) lanes.set(key, []);
    lanes.get(key).push(e);
  }
  const ordered = [...lanes.entries()].sort((a, b) => b[1].length - a[1].length).slice(0, 14);
  const W = 920, LABEL = 190, ROW = 18;
  const sx = t => LABEL + (W - LABEL) * Math.max(0, t - start) / (end - start || 1);
  let svg = "";
  // time gridlines every quarter-window
  for (let i = 0; i <= 4; i++) {
    const t = start + (end - start) * i / 4;
    svg += `<line x1="${sx(t).toFixed(1)}" y1="0" x2="${sx(t).toFixed(1)}" y2="${ordered.length * ROW}" stroke="#2a323d"/>
      <text x="${sx(t).toFixed(1)}" y="${ordered.length * ROW + 12}" fill="#8a94a0" font-size="10">-${((end - t) / 1e6).toFixed(0)}s</text>`;
  }
  ordered.forEach(([key, evs], i) => {
    const y = i * ROW;
    svg += `<text x="0" y="${y + 13}" fill="#9fb3c8" font-size="10">${esc(key.replace("node:", "").slice(0, 28))}</text>`;
    for (const e of evs) {
      const x0 = sx(e.ts), x1 = sx(e.ts + e.dur);
      const color = (e.args || {}).state === "FAILED" ? "#e07a5f"
        : (e.args || {}).state === "FINISHED" ? "#7fd1b9" : "#e8c268";
      svg += `<rect x="${x0.toFixed(1)}" y="${y + 3}" width="${Math.max(1.5, x1 - x0).toFixed(1)}" height="${ROW - 6}"
        fill="${color}" opacity="0.85"><title>${esc(e.name)} ${(e.dur / 1e3).toFixed(1)}ms ${esc((e.args || {}).state || "")}</title></rect>`;
    }
  });
  $("timeline").innerHTML =
    `<svg width="${W}" height="${ordered.length * ROW + 16}">${svg}</svg>`;
}
async function searchLogs() {
  const q = $("logq").value;
  if (!q) { $("logsearch").textContent = ""; return; }
  const res = await get(`/api/logs/search?q=${encodeURIComponent(q)}&limit=200`);
  $("logsearch").textContent = (res && res.matches || [])
    .map(m => `[${m.node.slice(0, 12)}] ${m.line}`).join("\\n") || "(no matches)";
}
async function refreshUtil() {
  const hist = await get("/api/metrics_history?minutes=15");
  if (!hist) return;
  const rowsHtml = Object.entries(hist.nodes || {}).map(([node, pts]) => {
    // tpu_mem_percent: the reporter's key, the CUDA card's memory in use
    const tpu = pts.some(p => p.tpu_mem_percent != null)
      ? `<td>gpu mem ${spark(pts, "tpu_mem_percent", "#e8c268")}</td>` : "";
    return `<tr><td>${esc(node.slice(0, 12))}</td>
      <td>cpu ${spark(pts, "cpu_percent", "#7fd1b9")}</td>
      <td>mem ${spark(pts, "mem_percent", "#9fb3c8")}</td>${tpu}</tr>`;
  }).join("");
  $("util").innerHTML = rowsHtml ? `<table>${rowsHtml}</table>` : "(no samples yet)";
}
async function refreshLogs() {
  const sel = $("lognode");
  const nodes = await get("/api/nodes");
  if (nodes) {
    const current = sel.value;
    const opts = nodes.nodes.filter(n => !n.is_head).map(n => n.node_id);
    if (opts.join() !== [...sel.options].map(o => o.value).join()) {
      sel.innerHTML = opts.map(v => `<option value="${esc(v)}">${esc(v.slice(0, 12))}</option>`).join("");
      if (opts.includes(current)) sel.value = current;
    }
  }
  if (!sel.value) { $("nodelogs").textContent = "(no remote nodes)"; return; }
  const logs = await get(`/api/nodes/${sel.value}/logs?lines=100`);
  if (logs) $("nodelogs").textContent = (logs.lines || []).join("\\n") || "(no worker logs yet)";
}
refresh();
setInterval(refresh, 2000);
</script>
</body>
</html>
"""
