"""Swagger / OpenAPI serving — counterpart of ``gofr_tpu/swagger.py``.

When ``./static/openapi.json`` exists at start, the app serves it at
``/.well-known/openapi.json`` and a self-contained viewer (no CDN: it
works without egress) at ``/.well-known/swagger``: each operation
expands, takes its path and query parameters and a JSON body, and runs
against the live server, showing the status, time and response. The
static-files route (``App.add_static_files``) refuses ``openapi.json``
with a 403.
"""

from __future__ import annotations

import json

from aiohttp import web

__all__ = ["openapi_handler", "swagger_ui_handler"]

_VIEWER_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>API Documentation</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2rem; background: #fafafa; }
 h1 { color: #1a1a2e; } h2 { margin-top: 2rem; }
 .op { border: 1px solid #ddd; border-radius: 6px; margin: .5rem 0; background: #fff; }
 .op-head { padding: .7rem 1rem; cursor: pointer; }
 .op-body { display: none; padding: .7rem 1rem; border-top: 1px solid #eee; }
 .op.open .op-body { display: block; }
 .method { display: inline-block; min-width: 4.5rem; font-weight: 700; }
 .GET { color: #0b7285; } .POST { color: #2b8a3e; } .PUT { color: #e67700; }
 .DELETE { color: #c92a2a; } .PATCH { color: #5f3dc4; }
 .path { font-family: ui-monospace, monospace; }
 .summary { color: #555; margin-left: .75rem; }
 label { display: block; margin: .4rem 0 .15rem; font-size: .85rem; color: #444; }
 input, textarea { width: 100%; box-sizing: border-box; font-family: ui-monospace, monospace;
   padding: .35rem; border: 1px solid #ccc; border-radius: 4px; }
 textarea { min-height: 5rem; }
 button { margin-top: .6rem; padding: .45rem 1.1rem; border: 0; border-radius: 4px;
   background: #1a1a2e; color: #fff; font-weight: 600; cursor: pointer; }
 button:hover { background: #33335c; }
 .result { margin-top: .6rem; }
 .status { font-weight: 700; } .ok { color: #2b8a3e; } .err { color: #c92a2a; }
 pre { background: #f1f3f5; padding: 1rem; border-radius: 6px; overflow-x: auto; }
</style>
</head>
<body>
<h1 id="title">API Documentation</h1>
<div id="ops"></div>
<h2>Raw specification</h2>
<pre id="raw"></pre>
<script>
function el(tag, attrs, text) {
  const e = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs || {})) e.setAttribute(k, v);
  if (text !== undefined) e.textContent = text;
  return e;
}
fetch('/.well-known/openapi.json').then(r => r.json()).then(spec => {
  document.getElementById('title').textContent =
    (spec.info && spec.info.title) || 'API Documentation';
  document.getElementById('raw').textContent = JSON.stringify(spec, null, 2);
  const ops = document.getElementById('ops');
  for (const [path, methods] of Object.entries(spec.paths || {})) {
    for (const [method, op] of Object.entries(methods)) {
      // path items also carry non-operation keys (parameters, servers)
      if (!['get','post','put','delete','patch','head','options']
            .includes(method)) continue;
      if (typeof op !== 'object' || op === null) continue;
      const m = method.toUpperCase();
      const div = el('div', {class: 'op'});
      const head = el('div', {class: 'op-head'});
      head.appendChild(el('span', {class: 'method ' + m}, m));
      head.appendChild(el('span', {class: 'path'}, path));
      head.appendChild(el('span', {class: 'summary'}, (op && op.summary) || ''));
      div.appendChild(head);
      const body = el('div', {class: 'op-body'});

      // parameter inputs: path-item-level parameters apply to every
      // operation under the path; merge them with the op's own
      const params = (methods.parameters || []).concat(op.parameters || [])
        .filter(p => p.in === 'path' || p.in === 'query');
      const inputs = {};
      for (const p of params) {
        body.appendChild(el('label', {}, p.in + ': ' + p.name +
                            (p.required ? ' *' : '')));
        inputs[p.name] = body.appendChild(
          el('input', {placeholder: (p.schema && p.schema.type) || 'string'}));
      }
      // request body editor for methods that carry one
      let bodyBox = null;
      if (m !== 'GET' && m !== 'DELETE') {
        body.appendChild(el('label', {}, 'request body (JSON)'));
        bodyBox = body.appendChild(el('textarea', {}));
        const rb = op.requestBody && op.requestBody.content &&
          op.requestBody.content['application/json'];
        if (rb && rb.example) bodyBox.value = JSON.stringify(rb.example, null, 2);
      }
      const btn = body.appendChild(el('button', {}, 'Execute'));
      const result = body.appendChild(el('div', {class: 'result'}));
      btn.onclick = async () => {
        let url = path;
        const qs = new URLSearchParams();
        for (const p of params) {
          const v = inputs[p.name].value;
          if (p.in === 'path') url = url.replace('{' + p.name + '}',
                                                 encodeURIComponent(v));
          else if (v !== '') qs.set(p.name, v);
        }
        if ([...qs].length) url += '?' + qs.toString();
        const init = {method: m, headers: {}};
        if (bodyBox && bodyBox.value.trim() !== '') {
          init.headers['Content-Type'] = 'application/json';
          init.body = bodyBox.value;
        }
        result.textContent = '...';
        const t0 = performance.now();
        try {
          const resp = await fetch(url, init);
          const ms = Math.round(performance.now() - t0);
          const text = await resp.text();
          result.textContent = '';
          result.appendChild(el('div', {class: 'status ' +
                                        (resp.ok ? 'ok' : 'err')},
                                resp.status + ' ' + resp.statusText +
                                ' · ' + ms + ' ms'));
          let shown = text;
          try { shown = JSON.stringify(JSON.parse(text), null, 2); } catch (e) {}
          result.appendChild(el('pre', {}, shown));
        } catch (e) {
          result.textContent = '';
          result.appendChild(el('div', {class: 'status err'}, String(e)));
        }
      };
      div.appendChild(body);
      head.onclick = () => div.classList.toggle('open');
      ops.appendChild(div);
    }
  }
});
</script>
</body>
</html>
"""


def openapi_handler(spec_path: str):
    async def handler(_: web.Request) -> web.Response:
        try:
            with open(spec_path, "r", encoding="utf-8") as fh:
                spec = json.load(fh)
        except (OSError, json.JSONDecodeError) as exc:
            return web.json_response(
                {"error": {"message": f"cannot read openapi spec: {exc}"}},
                status=500)
        return web.json_response(spec)

    return handler


def swagger_ui_handler():
    async def handler(_: web.Request) -> web.Response:
        return web.Response(text=_VIEWER_HTML, content_type="text/html")

    return handler
