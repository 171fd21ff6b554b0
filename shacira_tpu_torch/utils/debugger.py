"""Standalone-HTML 3D debugger for point clouds, curves and meshes.

The port's copy of ``shacira_tpu/utils/debugger.py``: ``PsDebugger``
collects structures and per-structure quantities and writes them into a
self-contained HTML file (a canvas orbit viewer, no external assets) that
opens anywhere, so no display is needed where the program runs.  Tensors
are accepted where arrays are.

    dbg = PsDebugger()
    dbg.register_point_cloud('samples', pts)            # [N, 3]
    dbg.add_color_quantity('samples', 'rgb', cols)      # [N, 3]
    dbg.add_scalar_quantity('samples', 'density', d)    # [N]
    dbg.register_curve_network('rays', segs)            # [M, 2, 3]
    dbg.add_surface_mesh('object', 'mesh.obj')
    dbg.show('debug.html')
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch


def _np(a, shape_tail=None):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a, np.float32)
    if shape_tail is not None:
        a = a.reshape(-1, *shape_tail) if shape_tail else a.reshape(-1)
    return a


class PsDebugger:
    def __init__(self):
        self.structures: Dict[str, dict] = {}

    # -- structures ---------------------------------------------------------
    def register_point_cloud(self, name: str, pts, **kwargs):
        self.structures[name] = {
            'kind': 'points', 'pos': _np(pts, (3,)), 'quantities': {}}

    def register_curve_network(self, name: str, segs, **kwargs):
        """segs: [M, 2, 3] or flat [2M, 3] consecutive start/end pairs."""
        p = _np(segs, (3,))
        self.structures[name] = {
            'kind': 'curves', 'pos': p.reshape(-1, 2, 3), 'quantities': {}}

    def add_surface_mesh(self, name: str, obj_path: str, **kwargs):
        from shacira_tpu_torch.ops.mesh import load_obj
        verts, faces = load_obj(obj_path)
        self.structures[name] = {
            'kind': 'mesh', 'pos': _np(verts, (3,)),
            'faces': np.asarray(faces, np.int32), 'quantities': {}}

    # -- per-structure quantities ------------------------------------------
    def add_scalar_quantity(self, struct: str, qname: str, vals, **kwargs):
        v = _np(vals, ())
        lo, hi = float(v.min()), float(v.max())
        t = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
        # viridis-ish two-point ramp, enough for debug color-coding
        col = np.stack([t, 0.2 + 0.6 * t, 1.0 - t], -1)
        self.structures[struct]['quantities'][qname] = col

    def add_color_quantity(self, struct: str, qname: str, cols, **kwargs):
        self.structures[struct]['quantities'][qname] = _np(cols, (3,))

    def add_vector_quantity(self, struct: str, qname: str, vecs,
                            scale: float = 0.05, **kwargs):
        """Vectors become a derived curve network rooted at the points."""
        base = self.structures[struct]['pos'].reshape(-1, 3)
        v = _np(vecs, (3,))
        segs = np.stack([base, base + scale * v], axis=1)
        self.register_curve_network(f'{struct}/{qname}', segs)

    # -- output -------------------------------------------------------------
    def payload(self) -> dict:
        out = {}
        for name, s in self.structures.items():
            entry = {'kind': s['kind'],
                     'pos': np.round(s['pos'], 5).reshape(
                         -1, 3).tolist()}
            if s['kind'] == 'curves':
                entry['pairs'] = True
            if 'faces' in s:
                entry['faces'] = s['faces'].reshape(-1, 3).tolist()
            if s['quantities']:
                qname, col = next(iter(s['quantities'].items()))
                entry['color'] = np.round(col, 4).tolist()
                entry['color_name'] = qname
            out[name] = entry
        return out

    def show(self, path: str = 'debug.html') -> str:
        """Write the standalone viewer; returns the path."""
        html = _HTML_TEMPLATE.replace(
            '__DATA__', json.dumps(self.payload()))
        with open(path, 'w') as f:
            f.write(html)
        return os.path.abspath(path)


_HTML_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>shacira_tpu_torch debugger</title>
<style>body{margin:0;background:#111;color:#ddd;font:12px monospace}
#hud{position:fixed;top:8px;left:8px}</style></head>
<body><canvas id="c"></canvas><div id="hud"></div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let az = 0.7, el = 0.4, dist = 3.2, cx = 0, cy = 0, cz = 0;
function resize(){cv.width = innerWidth; cv.height = innerHeight;}
addEventListener('resize', () => {resize(); draw();});
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => { if (!drag) return;
  az += (e.clientX - drag[0]) * 0.01; el += (e.clientY - drag[1]) * 0.01;
  el = Math.max(-1.5, Math.min(1.5, el)); drag = [e.clientX, e.clientY];
  draw(); });
cv.onwheel = e => { dist *= Math.exp(e.deltaY * 0.001); draw(); };
function proj(p){
  const ca = Math.cos(az), sa = Math.sin(az);
  const ce = Math.cos(el), se = Math.sin(el);
  let x = p[0] - cx, y = p[1] - cy, z = p[2] - cz;
  let x1 = ca * x + sa * z, z1 = -sa * x + ca * z;
  let y2 = ce * y - se * z1, z2 = se * y + ce * z1 + dist;
  if (z2 < 0.05) return null;
  const f = 0.9 * Math.min(cv.width, cv.height);
  return [cv.width / 2 + f * x1 / z2, cv.height / 2 - f * y2 / z2, z2];
}
function draw(){
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, cv.width, cv.height);
  let names = [];
  for (const [name, s] of Object.entries(DATA)) {
    names.push(name + ' (' + s.kind + ', ' + s.pos.length + ')');
    const col = i => s.color ?
      `rgb(${s.color[i].map(v=>Math.round(255*v)).join(',')})` : '#7fd4ff';
    if (s.kind === 'points') {
      for (let i = 0; i < s.pos.length; i++) {
        const q = proj(s.pos[i]); if (!q) continue;
        ctx.fillStyle = col(i); ctx.fillRect(q[0], q[1], 2, 2); }
    } else if (s.kind === 'curves') {
      ctx.strokeStyle = '#ffd27f';
      for (let i = 0; i + 1 < s.pos.length; i += 2) {
        const a = proj(s.pos[i]), b = proj(s.pos[i + 1]);
        if (!a || !b) continue;
        ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
        ctx.stroke(); }
    } else if (s.kind === 'mesh') {
      ctx.strokeStyle = '#9f9';
      for (const f of (s.faces || [])) {
        const t = f.map(i => proj(s.pos[i])); if (t.some(v => !v)) continue;
        ctx.beginPath(); ctx.moveTo(t[0][0], t[0][1]);
        ctx.lineTo(t[1][0], t[1][1]); ctx.lineTo(t[2][0], t[2][1]);
        ctx.closePath(); ctx.stroke(); }
    }
  }
  document.getElementById('hud').innerText =
    names.join('\\n') + '\\ndrag: orbit   wheel: zoom';
}
resize(); draw();
</script></body></html>
"""
