"""DA3 scene gallery server (two-level group/scene browser), a copy of
``videogpa_tpu/models/da3/gallery.py``.

Functional equivalent of the reference gallery service
(``depth_anything_3/services/gallery.py:1-806``): a stdlib
``ThreadingHTTPServer`` over an export root laid out as
``<root>/<group>/<scene>/{scene.glb, scene.jpg, depth_vis/*.png}`` with

    GET /                        interactive browser page (embedded HTML)
    GET /manifest.json           {"groups": [{"id", "title"}, ...]}
    GET /manifest/<group>.json   {"group", "items": [{"id", "title",
                                  "model", "thumbnail", "depth_images"}]}
    GET /<group>/<scene>/...     static artifact serving
                                 (directory listing disabled)

A group is listed when at least one scene has both ``scene.glb`` and
``scene.jpg`` (reference ``gallery.py:641-665``); a scene item carries its
glb, jpg thumbnail and every image under ``depth_vis/``
(``gallery.py:668-701``). The embedded page re-creates the reference's
interaction surface — group grid -> searchable, paginated scene grid
(16/page) -> viewer overlay with an interactive 3D point-cloud stage and a
paginated depth-image strip (4/page), with query-string URL routing so
views are linkable — as an original, much smaller implementation (the
reference page is ~600 lines of themed JS; gradio-era styling is out of
scope here). The 3D stage is a built-in dependency-free viewer: it parses
the ``export_glb`` layout (POSITION + COLOR_0 float32 accessors, mode
POINTS — ``export.py``) and renders with a software z-buffer
(drag-orbit / wheel-zoom / auto-rotate), so the page loads NOTHING from
the network and works on air-gapped hosts — unlike a CDN
``<model-viewer>`` tag, and matching the reference app's self-hosted
viewer capability.
"""

from __future__ import annotations

import json
import mimetypes
import os
import posixpath
from functools import partial
from http import HTTPStatus
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import quote, unquote

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def _url_join(*parts: str) -> str:
    norm = posixpath.join(*[p.replace("\\", "/") for p in parts])
    segs = [s for s in norm.split("/") if s not in ("", ".")]
    return "/".join(quote(s) for s in segs)


def _is_plain_name(name: str) -> bool:
    """True for a single path component (no separators, not . / ..)."""
    return name not in (".", "..") and all(c not in name for c in "/\\")


def _scene_complete(scene_dir: str) -> bool:
    return os.path.exists(os.path.join(scene_dir, "scene.glb")) and os.path.exists(
        os.path.join(scene_dir, "scene.jpg")
    )


def build_group_list(root_dir: str) -> dict:
    """Groups (first directory level) holding >=1 complete scene."""
    groups = []
    if os.path.isdir(root_dir):
        for gname in sorted(os.listdir(root_dir)):
            gpath = os.path.join(root_dir, gname)
            if not os.path.isdir(gpath):
                continue
            if any(
                os.path.isdir(os.path.join(gpath, s))
                and _scene_complete(os.path.join(gpath, s))
                for s in os.listdir(gpath)
            ):
                groups.append({"id": gname, "title": gname})
    return {"groups": groups}


def build_group_manifest(root_dir: str, group: str) -> dict:
    """Scene items of one group: glb + thumbnail + depth_vis image URLs."""
    items = []
    gpath = os.path.join(root_dir, group)
    if os.path.isdir(gpath):
        for sname in sorted(os.listdir(gpath)):
            spath = os.path.join(gpath, sname)
            if not (os.path.isdir(spath) and _scene_complete(spath)):
                continue
            depth_images = []
            dvis = os.path.join(spath, "depth_vis")
            if os.path.isdir(dvis):
                for fn in sorted(os.listdir(dvis)):
                    if os.path.splitext(fn)[1].lower() in IMAGE_EXTS:
                        depth_images.append(
                            "/" + _url_join(group, sname, "depth_vis", fn)
                        )
            items.append(
                {
                    "id": sname,
                    "title": sname,
                    "model": "/" + _url_join(group, sname, "scene.glb"),
                    "thumbnail": "/" + _url_join(group, sname, "scene.jpg"),
                    "depth_images": depth_images,
                }
            )
    return {"group": group, "items": items}


GALLERY_PAGE = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<title>DA3 Gallery</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
 body{font:15px/1.5 system-ui,sans-serif;margin:0;background:#111;color:#eee}
 header{padding:14px 20px;border-bottom:1px solid #333;display:flex;
        gap:14px;align-items:center}
 header h1{font-size:18px;margin:0}
 #search{background:#222;color:#eee;border:1px solid #444;border-radius:6px;
         padding:5px 10px;display:none}
 #crumb{color:#8ad;cursor:pointer}
 main{max-width:1100px;margin:18px auto;padding:0 16px}
 .grid{display:grid;grid-template-columns:repeat(auto-fill,minmax(200px,1fr));
       gap:14px}
 .card{background:#1c1c22;border-radius:10px;overflow:hidden;cursor:pointer;
       border:1px solid #2a2a33}
 .card:hover{border-color:#58f}
 .card img{width:100%;aspect-ratio:2/1;object-fit:cover;display:block}
 .card .t{padding:8px 10px;font-size:13px;white-space:nowrap;
          overflow:hidden;text-overflow:ellipsis}
 .group{padding:22px 14px;font-size:15px;text-align:center}
 .pager{display:flex;gap:10px;justify-content:center;margin:16px 0}
 .pager button{background:#222;color:#eee;border:1px solid #444;
               border-radius:6px;padding:4px 12px;cursor:pointer}
 .pager button:disabled{opacity:.35;cursor:default}
 #overlay{position:fixed;inset:0;background:rgba(0,0,0,.82);display:none;
          align-items:center;justify-content:center;z-index:9}
 #overlay.show{display:flex}
 #panel{background:#15151b;border-radius:12px;max-width:980px;width:94%;
        max-height:92vh;overflow:auto;padding:16px}
 #panel canvas{width:100%;height:420px;background:#0b0d12;display:block;
               border-radius:8px;cursor:grab;touch-action:none}
 #depths{display:grid;grid-template-columns:repeat(4,1fr);gap:8px;
         margin-top:10px}
 #depths img{width:100%;border-radius:6px}
 #close{float:right;cursor:pointer;font-size:20px;color:#aaa}
 .muted{color:#888;font-size:13px}
</style></head><body>
<header><h1 id="crumb">DA3 Gallery</h1>
<input id="search" placeholder="filter scenes…">
<span class="muted" id="hint">pick a group</span></header>
<main><div class="pager" id="topPager"></div><div class="grid" id="grid"></div>
<div class="pager" id="botPager"></div></main>
<div id="overlay"><div id="panel"><span id="close">&times;</span>
<h3 id="vtitle"></h3><canvas id="mv" height="420"></canvas>
<div class="muted">drag to orbit &middot; wheel to zoom</div>
<div class="pager" id="dpager"></div><div id="depths"></div></div></div>
<script>
const PER_PAGE = 16, DEPTH_PER_PAGE = 4;
let GROUPS = [], SCENES = [], curGroup = null;
const $ = id => document.getElementById(id);
const qs = () => new URLSearchParams(location.search);

function setURL(params, push) {
  const u = new URL(location.href);
  u.search = new URLSearchParams(params).toString();
  (push ? history.pushState : history.replaceState).call(history, null, '', u);
}
function pager(el, page, pages, go) {
  el.innerHTML = '';
  if (pages <= 1) return;
  const mk = (txt, dis, fn) => {
    const b = document.createElement('button');
    b.textContent = txt; b.disabled = dis; b.onclick = fn;
    el.appendChild(b);
  };
  mk('\\u2190 prev', page <= 1, () => go(page - 1));
  const s = document.createElement('span');
  s.textContent = page + ' / ' + pages;
  el.appendChild(s);
  mk('next \\u2192', page >= pages, () => go(page + 1));
}
function showGroups() {
  curGroup = null;
  $('search').style.display = 'none';
  $('hint').textContent = 'pick a group';
  $('topPager').innerHTML = $('botPager').innerHTML = '';
  const g = $('grid'); g.innerHTML = '';
  for (const it of GROUPS) {
    const c = document.createElement('div');
    c.className = 'card'; c.innerHTML = '<div class="group"></div>';
    c.firstChild.textContent = it.title;
    c.onclick = () => { setURL({group: it.id}, true); openGroup(it.id); };
    g.appendChild(c);
  }
  if (!GROUPS.length) g.innerHTML = '<p class="muted">no scenes found</p>';
}
async function openGroup(id) {
  curGroup = id;
  const m = await (await fetch('/manifest/' + encodeURIComponent(id) +
                               '.json')).json();
  SCENES = m.items;
  $('search').style.display = ''; $('search').value = '';
  $('hint').textContent = id + ' \\u2014 ' + SCENES.length + ' scenes';
  renderScenes(parseInt(qs().get('page') || '1', 10) || 1);
}
function renderScenes(page) {
  const q = $('search').value.trim().toLowerCase();
  const f = SCENES.filter(x => x.id.toLowerCase().includes(q));
  const pages = Math.max(1, Math.ceil(f.length / PER_PAGE));
  page = Math.min(Math.max(1, page), pages);
  setURL({group: curGroup, page: page}, false);
  const g = $('grid'); g.innerHTML = '';
  for (const it of f.slice((page - 1) * PER_PAGE, page * PER_PAGE)) {
    const c = document.createElement('div');
    c.className = 'card';
    const img = document.createElement('img');
    img.loading = 'lazy'; img.src = it.thumbnail;
    const t = document.createElement('div');
    t.className = 't'; t.textContent = it.title;
    c.appendChild(img); c.appendChild(t);
    c.onclick = () => {
      setURL({group: curGroup, page: page, id: it.id}, true);
      openViewer(it);
    };
    g.appendChild(c);
  }
  for (const el of [$('topPager'), $('botPager')])
    pager(el, page, pages, p => renderScenes(p));
}
// Built-in glb point-cloud viewer: parses the export_glb layout (POSITION
// + COLOR_0 float32 VEC3 accessors, mode POINTS — export.py:export_glb)
// and renders with a software z-buffer. No external scripts, so the
// gallery works on air-gapped hosts where a CDN is unreachable.
const viewer = (() => {
  const cv = $('mv'), ctx = cv.getContext('2d');
  const MAXPTS = 400000;               // interactivity cap; stride-sampled
  let px, py, pz, pc, n = 0;           // normalized cloud + ABGR colors
  let yaw = 0.7, pitch = -0.35, dist = 2.4;
  let auto = true, raf = 0, tok = 0, msg = '';
  let img = null, buf32 = null, zb = null;
  function parseGlbPoints(ab) {
    const dv = new DataView(ab);
    if (dv.getUint32(0, true) !== 0x46546C67) throw new Error('not a glb');
    let off = 12, js = null, bin = null;
    while (off + 8 <= dv.byteLength) {
      const len = dv.getUint32(off, true), ty = dv.getUint32(off + 4, true);
      const chunk = ab.slice(off + 8, off + 8 + len);
      if (ty === 0x4E4F534A) js = JSON.parse(new TextDecoder().decode(chunk));
      if (ty === 0x004E4942) bin = chunk;
      off += 8 + len;
    }
    if (!js || !bin) throw new Error('missing glb chunk');
    const acc = i => {
      const a = js.accessors[i], v = js.bufferViews[a.bufferView];
      return new Float32Array(bin, (v.byteOffset || 0) + (a.byteOffset || 0),
                              a.count * 3);
    };
    const at = js.meshes[0].primitives[0].attributes;
    return [acc(at.POSITION),
            at.COLOR_0 != null ? acc(at.COLOR_0) : null];
  }
  function setCloud(pos, col) {
    const m = pos.length / 3, stride = Math.max(1, Math.ceil(m / MAXPTS));
    n = Math.floor((m + stride - 1) / stride);
    px = new Float32Array(n); py = new Float32Array(n);
    pz = new Float32Array(n); pc = new Uint32Array(n);
    let cx = 0, cy = 0, cz = 0;
    for (let i = 0, j = 0; j < n; i += stride, j++) {
      px[j] = pos[3*i]; py[j] = pos[3*i+1]; pz[j] = pos[3*i+2];
      cx += px[j]; cy += py[j]; cz += pz[j];
      if (col) {
        const r = Math.min(255, col[3*i] * 255) | 0,
              g = Math.min(255, col[3*i+1] * 255) | 0,
              b = Math.min(255, col[3*i+2] * 255) | 0;
        pc[j] = 0xFF000000 | (b << 16) | (g << 8) | r;
      } else pc[j] = 0xFFD8D8D8;
    }
    cx /= n; cy /= n; cz /= n;
    let r2 = 1e-9;
    for (let j = 0; j < n; j++) {
      px[j] -= cx; py[j] -= cy; pz[j] -= cz;
      r2 = Math.max(r2, px[j]*px[j] + py[j]*py[j] + pz[j]*pz[j]);
    }
    const s = 1 / Math.sqrt(r2);
    for (let j = 0; j < n; j++) { px[j] *= s; py[j] *= s; pz[j] *= s; }
  }
  function frame() {
    raf = requestAnimationFrame(frame);
    if (auto) yaw += 0.004;
    const w = cv.width, h = cv.height;
    if (!img || img.width !== w || img.height !== h) {
      img = ctx.createImageData(w, h);
      buf32 = new Uint32Array(img.data.buffer);
      zb = new Float32Array(w * h);
    }
    buf32.fill(0xFF120D0B);            // #0b0d12 background (ABGR)
    zb.fill(1e9);
    const cy = Math.cos(yaw), sy = Math.sin(yaw);
    const cp = Math.cos(pitch), sp = Math.sin(pitch);
    const f = 0.9 * Math.min(w, h);
    for (let i = 0; i < n; i++) {
      const x1 = cy*px[i] + sy*pz[i], z1 = -sy*px[i] + cy*pz[i];
      const y1 = cp*py[i] - sp*z1, z2 = sp*py[i] + cp*z1 + dist;
      if (z2 < 0.15) continue;
      const sx = (w/2 + f*x1/z2) | 0, syy = (h/2 - f*y1/z2) | 0;
      if (sx < 0 || sx >= w - 1 || syy < 0 || syy >= h - 1) continue;
      const c = pc[i];                 // 2x2 z-tested splat
      let k = syy * w + sx;
      if (z2 < zb[k]) { zb[k] = z2; buf32[k] = c; }
      if (z2 < zb[k+1]) { zb[k+1] = z2; buf32[k+1] = c; }
      k += w;
      if (z2 < zb[k]) { zb[k] = z2; buf32[k] = c; }
      if (z2 < zb[k+1]) { zb[k+1] = z2; buf32[k+1] = c; }
    }
    ctx.putImageData(img, 0, 0);
    if (msg) {
      ctx.fillStyle = '#9ab'; ctx.font = '13px system-ui';
      ctx.fillText(msg, 12, 22);
    }
  }
  cv.addEventListener('pointerdown', e => {
    auto = false; cv.setPointerCapture(e.pointerId);
    cv.style.cursor = 'grabbing';
    let lx = e.clientX, ly = e.clientY;
    const mv = ev => {
      yaw += (ev.clientX - lx) * 0.008;
      pitch = Math.min(1.5, Math.max(-1.5, pitch + (ev.clientY - ly) * 0.008));
      lx = ev.clientX; ly = ev.clientY;
    };
    const up = () => {
      cv.style.cursor = 'grab';
      cv.removeEventListener('pointermove', mv);
      cv.removeEventListener('pointerup', up);
      cv.removeEventListener('pointercancel', up);
    };
    cv.addEventListener('pointermove', mv);
    cv.addEventListener('pointerup', up);
    cv.addEventListener('pointercancel', up);
  });
  cv.addEventListener('wheel', e => {
    e.preventDefault();
    dist = Math.min(10, Math.max(0.8, dist * Math.exp(e.deltaY * 0.0012)));
  }, {passive: false});
  return {
    async load(url) {
      const t = ++tok;
      n = 0; msg = 'loading\\u2026'; auto = true;
      cv.width = Math.max(300, cv.clientWidth); cv.height = 420;
      if (!raf) frame();
      try {
        const ab = await (await fetch(url)).arrayBuffer();
        if (t !== tok) return;
        setCloud(...parseGlbPoints(ab));
        msg = '';
      } catch (err) { if (t === tok) msg = 'viewer: ' + err.message; }
    },
    stop() { if (raf) cancelAnimationFrame(raf); raf = 0; n = 0; tok++; },
  };
})();
function openViewer(it) {
  $('vtitle').textContent = it.id;
  renderDepths(it, 1);
  $('overlay').classList.add('show');
  viewer.load(it.model);
}
function renderDepths(it, page) {
  const pages = Math.max(1, Math.ceil(it.depth_images.length / DEPTH_PER_PAGE));
  page = Math.min(Math.max(1, page), pages);
  const d = $('depths'); d.innerHTML = '';
  for (const u of it.depth_images.slice((page - 1) * DEPTH_PER_PAGE,
                                        page * DEPTH_PER_PAGE)) {
    const img = document.createElement('img');
    img.loading = 'lazy'; img.src = u;
    d.appendChild(img);
  }
  pager($('dpager'), page, pages, p => renderDepths(it, p));
}
function closeViewer(push) {
  $('overlay').classList.remove('show'); viewer.stop();
  if (push) setURL({group: curGroup, page: qs().get('page') || 1}, true);
}
$('close').onclick = () => closeViewer(true);
$('overlay').onclick = e => { if (e.target.id === 'overlay') closeViewer(true); };
$('crumb').onclick = () => { setURL({}, true); showGroups(); };
$('search').oninput = () => renderScenes(1);
document.addEventListener('keydown', e => {
  if (e.key === 'Escape') closeViewer(true);
});
window.onpopstate = route;
async function route() {
  const g = qs().get('group'), id = qs().get('id');
  if (!GROUPS.length)
    GROUPS = (await (await fetch('/manifest.json')).json()).groups;
  if (!g) { showGroups(); return; }
  await openGroup(g);
  if (id) {
    const hit = SCENES.find(x => x.id === id);
    if (hit) openViewer(hit);
  } else closeViewer(false);
}
route();
</script></body></html>
"""


class GalleryHandler(SimpleHTTPRequestHandler):
    """Static files + manifest endpoints; directory listing disabled."""

    def _send_payload(self, body: bytes, content_type: str):
        self.send_response(HTTPStatus.OK)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/index.html") or self.path.startswith("/?"):
            return self._send_payload(
                GALLERY_PAGE.encode("utf-8"), "text/html; charset=utf-8"
            )
        if self.path == "/manifest.json":
            body = json.dumps(build_group_list(self.directory)).encode("utf-8")
            return self._send_payload(body, "application/json; charset=utf-8")
        if self.path.startswith("/manifest/") and self.path.endswith(".json"):
            group = unquote(self.path[len("/manifest/"):-len(".json")])
            if not _is_plain_name(group):
                return self.send_error(HTTPStatus.BAD_REQUEST, "Invalid group name")
            body = json.dumps(
                build_group_manifest(self.directory, group)
            ).encode("utf-8")
            return self._send_payload(body, "application/json; charset=utf-8")
        if self.path == "/favicon.ico":
            self.send_response(HTTPStatus.NO_CONTENT)
            self.end_headers()
            return None
        return super().do_GET()

    def list_directory(self, path):
        self.send_error(HTTPStatus.NOT_FOUND, "Directory listing disabled")
        return None

    def log_message(self, *args):  # quiet
        pass


def make_server(
    root_dir: str, host: str = "127.0.0.1", port: int = 0
) -> ThreadingHTTPServer:
    """Bind (but don't run) the gallery server; port 0 picks a free port."""
    mimetypes.add_type("model/gltf-binary", ".glb")
    handler = partial(GalleryHandler, directory=os.path.abspath(root_dir))
    return ThreadingHTTPServer((host, port), handler)


def serve(root_dir: str, host: str = "127.0.0.1", port: int = 8000) -> None:
    if not os.path.isdir(root_dir):
        raise NotADirectoryError(root_dir)
    server = make_server(root_dir, host, port)
    print(f"DA3 gallery serving {os.path.abspath(root_dir)} "
          f"on http://{host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
