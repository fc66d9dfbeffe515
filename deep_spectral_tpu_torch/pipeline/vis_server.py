"""Interactive visualization browser for pipeline outputs: the JAX package's
`pipeline/vis_server.py`, copied onto the port's `utils.serialization` and
`utils.sizes` (stdlib HTTP server, numpy and PIL; no torch compute).

The reference ships a streamlit app (reference: extract/extract.py:738-834)
that pages through image / bbox-overlay / label2rgb-segmap panels. This is
the same capability as a stdlib HTTP server and a single-page client:

    python -m deep_spectral_tpu_torch.pipeline vis_server --images_list ... \
        --images_root ... --segmentations_dir ... [--bbox_file ...] \
        [--eigs_dir ...] [--port 7860]

then open http://127.0.0.1:7860. Keyboard: left/right arrows page through
images; the segment overlay has an opacity slider; bboxes toggle on/off;
eigenvector heatmaps render as native patch-resolution PNGs scaled
client-side with ``image-rendering: pixelated``.

Only ids from ``images_list`` are servable: requests are dict lookups, not
filesystem paths, so there is no traversal surface.
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.serialization import load_pth, load_segmap_png
from ..utils.sizes import infer_patch_grid

# 21-color label palette (label 0 = background, rendered transparent in the
# overlay). Matches the tab20-ish coloring of the static gallery.
PALETTE = np.array([
    (0, 0, 0), (31, 119, 180), (255, 127, 14), (44, 160, 44),
    (214, 39, 40), (148, 103, 189), (140, 86, 75), (227, 119, 194),
    (127, 127, 127), (188, 189, 34), (23, 190, 207), (174, 199, 232),
    (255, 187, 120), (152, 223, 138), (255, 152, 150), (197, 176, 213),
    (196, 156, 148), (247, 182, 210), (199, 199, 199), (219, 219, 141),
    (158, 218, 229),
], dtype=np.uint8)

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>deep_spectral_tpu viewer</title>
<style>
 body { margin:0; font:14px system-ui, sans-serif; display:flex; height:100vh; }
 #side { width:230px; overflow-y:auto; border-right:1px solid #ccc; padding:8px; }
 #side div { cursor:pointer; padding:2px 6px; border-radius:4px;
             white-space:nowrap; overflow:hidden; text-overflow:ellipsis; }
 #side div.sel { background:#1f77b4; color:#fff; }
 #main { flex:1; overflow-y:auto; padding:12px; }
 #stage { position:relative; display:inline-block; max-width:100%; }
 #stage img.base { display:block; max-width:100%; }
 #stage img.seg { position:absolute; inset:0; width:100%; height:100%;
                  image-rendering:pixelated; pointer-events:none; }
 #stage svg { position:absolute; inset:0; width:100%; height:100%;
              pointer-events:none; }
 #eigs img { image-rendering:pixelated; height:96px; margin:2px;
             border:1px solid #ddd; }
 #bar { margin-bottom:8px; display:flex; gap:16px; align-items:center; }
 rect { fill:none; stroke:red; stroke-width:2px;
        vector-effect:non-scaling-stroke; }
</style></head><body>
<div id="side"></div>
<div id="main">
 <div id="bar">
  <b id="title"></b>
  <label>segments <input id="op" type="range" min="0" max="100" value="45">
  </label>
  <label><input id="bx" type="checkbox" checked> boxes</label>
  <span id="pos"></span>
 </div>
 <div id="stage"><img class="base" id="im">
  <img class="seg" id="sg"><svg id="ov"></svg></div>
 <div id="eigs"></div>
</div>
<script>
let items = [], cur = 0;
const $ = id => document.getElementById(id);
async function load() {
  items = (await (await fetch('api/index')).json()).items;
  const side = $('side');
  items.forEach((it, i) => {
    const d = document.createElement('div');
    d.textContent = it.id; d.onclick = () => show(i);
    side.appendChild(d);
  });
  if (items.length) show(0);
}
async function show(i) {
  cur = i;
  const it = items[i];
  [...$('side').children].forEach((d, j) =>
      d.classList.toggle('sel', j === i));
  $('title').textContent = it.id;
  $('pos').textContent = (i + 1) + ' / ' + items.length;
  $('im').src = 'image/' + encodeURIComponent(it.id);
  $('sg').src = it.has_seg ? 'seg/' + encodeURIComponent(it.id) : '';
  $('sg').style.opacity = it.has_seg ? $('op').value / 100 : 0;
  const ov = $('ov'); ov.innerHTML = '';
  if (it.boxes && $('bx').checked) {
    $('im').decode().then(() => {
      ov.setAttribute('viewBox', '0 0 ' + $('im').naturalWidth + ' ' +
                      $('im').naturalHeight);
      ov.setAttribute('preserveAspectRatio', 'none');
      for (const [x0, y0, x1, y1] of it.boxes) {
        const r = document.createElementNS('http://www.w3.org/2000/svg',
                                           'rect');
        r.setAttribute('x', x0); r.setAttribute('y', y0);
        r.setAttribute('width', x1 - x0); r.setAttribute('height', y1 - y0);
        ov.appendChild(r);
      }
    });
  }
  const eigs = $('eigs'); eigs.innerHTML = '';
  if (it.has_eigs) for (let k = 0; k < 8; k++) {
    const im = document.createElement('img');
    im.src = 'eig/' + encodeURIComponent(it.id) + '/' + k;
    im.title = 'eigenvector ' + k;
    im.onerror = () => im.remove();
    eigs.appendChild(im);
  }
}
$('op').oninput = () => { $('sg').style.opacity = $('op').value / 100; };
$('bx').onchange = () => show(cur);
document.onkeydown = e => {
  if (e.key === 'ArrowRight' && cur + 1 < items.length) show(cur + 1);
  if (e.key === 'ArrowLeft' && cur > 0) show(cur - 1);
};
load();
</script></body></html>"""


def _png_bytes(arr: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


class _State:
    """Resolved dataset paths + tiny render cache, shared by request threads."""

    def __init__(self, images_list: str, images_root: str,
                 segmentations_dir: Optional[str], bbox_file: Optional[str],
                 eigs_dir: Optional[str], max_images: int):
        names = [n for n in Path(images_list).read_text().splitlines()
                 if n.strip()]
        if max_images:
            names = names[:max_images]
        self.images_root = Path(images_root)
        self.files = {Path(n).stem: n for n in names}
        self.ids = [Path(n).stem for n in names]
        self.seg_dir = Path(segmentations_dir) if segmentations_dir else None
        self.eigs_dir = Path(eigs_dir) if eigs_dir else None
        # bboxes.pth is one list of per-image dicts for the whole dataset
        # (reference: extract/extract.py:429-497); key by id, never position.
        self.boxes = {}
        if bbox_file:
            for bd in load_pth(bbox_file):
                self.boxes[bd["id"]] = [
                    [int(v) for v in b]
                    for b in bd.get("bboxes_original_resolution", [])]
        self._lock = threading.Lock()
        self._cache: dict[tuple, bytes] = {}

    def index(self) -> bytes:
        items = []
        for i in self.ids:
            items.append({
                "id": i,
                "has_seg": bool(self.seg_dir and
                                (self.seg_dir / f"{i}.png").is_file()),
                "has_eigs": bool(self.eigs_dir and
                                 (self.eigs_dir / f"{i}.pth").is_file()),
                "boxes": self.boxes.get(i),
            })
        return json.dumps({"items": items}).encode()

    def image(self, image_id: str) -> Optional[tuple[bytes, str]]:
        name = self.files.get(image_id)
        if name is None:
            return None
        ctype = {".png": "image/png"}.get(Path(name).suffix.lower(),
                                          "image/jpeg")
        return (self.images_root / name).read_bytes(), ctype

    def seg_png(self, image_id: str) -> Optional[bytes]:
        if self.seg_dir is None:
            return None
        path = self.seg_dir / f"{image_id}.png"
        if image_id not in self.files or not path.is_file():
            return None
        with self._lock:
            key = ("seg", image_id)
            if key not in self._cache:
                seg = load_segmap_png(path).astype(np.int64)
                if set(np.unique(seg).tolist()) == {0, 255}:
                    seg = (seg == 255).astype(np.int64)
                rgba = np.concatenate([
                    PALETTE[seg % len(PALETTE)],
                    np.where(seg[..., None] == 0, 0, 255).astype(np.uint8),
                ], axis=-1)
                self._cache[key] = _png_bytes(rgba)
            return self._cache[key]

    def eig_png(self, image_id: str, k: int) -> Optional[bytes]:
        if self.eigs_dir is None or image_id not in self.files:
            return None
        path = self.eigs_dir / f"{image_id}.pth"
        if not path.is_file():
            return None
        with self._lock:
            key = ("eig", image_id, k)
            if key not in self._cache:
                from PIL import Image
                vecs = np.asarray(load_pth(path)["eigenvectors"],
                                  dtype=np.float32)
                if not 0 <= k < vecs.shape[0]:
                    return None
                with Image.open(self.images_root / self.files[image_id]) as im:
                    W, H = im.size
                _, h_lr, w_lr = infer_patch_grid(vecs.shape[1], H, W)
                v = vecs[k].reshape(h_lr, w_lr)
                # Signed diverging render: blue negative, red positive.
                v = v / max(float(np.abs(v).max()), 1e-12)
                rgb = np.stack([np.clip(v, 0, 1), 1.0 - np.abs(v),
                                np.clip(-v, 0, 1)], axis=-1)
                self._cache[key] = _png_bytes(
                    (rgb * 255).astype(np.uint8))
            return self._cache[key]


def _make_handler(state: _State):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: Optional[bytes], ctype: str):
            if body is None:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            from urllib.parse import unquote
            parts = [unquote(p) for p in self.path.split("?")[0].split("/")
                     if p]
            try:
                if not parts:
                    self._send(_PAGE.encode(), "text/html; charset=utf-8")
                elif parts == ["api", "index"]:
                    self._send(state.index(), "application/json")
                elif parts[0] == "image" and len(parts) == 2:
                    img = state.image(parts[1])
                    self._send(*(img if img else (None, "")))
                elif parts[0] == "seg" and len(parts) == 2:
                    self._send(state.seg_png(parts[1]), "image/png")
                elif parts[0] == "eig" and len(parts) == 3:
                    self._send(state.eig_png(parts[1], int(parts[2])),
                               "image/png")
                else:
                    self._send(None, "")
            except (ValueError, OSError, KeyError):
                self._send(None, "")

    return Handler


def make_vis_server(images_list: str, images_root: str,
                    segmentations_dir: Optional[str] = None,
                    bbox_file: Optional[str] = None,
                    eigs_dir: Optional[str] = None,
                    host: str = "127.0.0.1", port: int = 7860,
                    max_images: int = 0) -> ThreadingHTTPServer:
    """Build (but don't start) the viewer server; tests drive it in a thread."""
    state = _State(images_list, images_root, segmentations_dir, bbox_file,
                   eigs_dir, max_images)
    return ThreadingHTTPServer((host, port), _make_handler(state))


def vis_server(images_list: str, images_root: str,
               segmentations_dir: Optional[str] = None,
               bbox_file: Optional[str] = None,
               eigs_dir: Optional[str] = None,
               host: str = "127.0.0.1", port: int = 7860,
               max_images: int = 0):
    """Serve the interactive browser (the streamlit-app equivalent,
    reference: extract/extract.py:738-834). Blocks until Ctrl-C."""
    srv = make_vis_server(images_list, images_root, segmentations_dir,
                          bbox_file, eigs_dir, host, port, max_images)
    print(f"viewer at http://{host}:{srv.server_address[1]}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
