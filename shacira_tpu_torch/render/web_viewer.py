"""Interactive web viewer: a small HTTP server renders frames on the card
and streams JPEGs to a browser.

Port of ``shacira_tpu/render/web_viewer.py``.  The page offers the
turntable (azimuth / elevation orbit, up locked to +Y, elevation clamped),
trackball (unclamped orbit) and first-person (mouse-look and WASD/QE)
controls, pan by shift- or right-drag, a quality knob that renders at a
fraction of the resolution while the camera moves (``q``; a full frame
once it rests), a toggle for the ``PrimitivesPack`` data layers, which are
composited on the host with the frame's depth buffer, and stat panels.

Endpoints: ``/`` (the page), ``/render`` (a JPEG of a lookat camera
``ox, oy, oz, tx, ty, tz``, or of the orbit ``theta, phi, radius``, with
``q`` and ``layers=1``; the headers ``X-Iteration`` and ``X-Frame-Ms``
say which training iteration it shows and how long it took), ``/stats``
(JSON panels).  A frame that fails is an HTTP 500 carrying the error.

Frames render under ``lock`` (an ``RLock`` a trainer may share: it holds
it through each step, so a frame never reads a half-applied step) and in
``torch.no_grad()`` on the render thread; all threads launch on the
device's default stream, so frames and steps serialize on the card.
``frame_fn``, when given, is called once a frame under the lock and
returns the frame's ``(trace_fn, iteration)`` (the trainer's parameters
decoded once a frame); else every frame traces ``trace_fn``.
"""
from __future__ import annotations

import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from shacira_tpu_torch.render.offline import (CameraConfig, lookat_rays,
                                              render_rays)

log = logging.getLogger('shacira_tpu_torch')

_PAGE = """<!DOCTYPE html>
<html><head><title>shacira_tpu_torch viewer</title><style>
 body{margin:0;background:#111;color:#eee;font-family:monospace}
 #v{display:block;margin:12px auto;border:1px solid #444;cursor:grab}
 #bar{text-align:center;margin:6px}
 select,label{background:#222;color:#eee;border:1px solid #444}
</style></head><body>
<div style="display:flex;justify-content:center;align-items:flex-start">
<img id="v" width="__W__" height="__H__"/>
<div id="panel" style="margin:12px;min-width:260px;max-width:320px;
 font-size:12px;border:1px solid #444;padding:8px"></div>
</div>
<div id="bar">
 mode <select id="mode"><option>turntable</option><option>trackball</option>
 <option>first-person</option></select>
 quality <select id="q"><option value="1">full</option>
 <option value="0.5" selected>half</option><option value="0.25">quarter</option></select>
 <label><input type="checkbox" id="layers"/>layers</label>
 <span id="s">drag orbit &middot; shift/right-drag pan &middot; wheel zoom &middot; WASDQE fly</span>
</div>
<script>
// stat panels: optimization progress, object properties, renderer
async function pollStats(){
  try{
    const r = await fetch('/stats'); const s = await r.json();
    let html='';
    for(const [group, rows] of Object.entries(s)){
      html+='<div style="color:#8cf;margin-top:6px">'+group+'</div>';
      for(const [k,v] of Object.entries(rows))
        html+='<div><span style="color:#999">'+k+'</span> '+v+'</div>';
    }
    document.getElementById('panel').innerHTML=html;
  }catch(e){}
}
setInterval(pollStats, 1000); pollStats();
</script>
<script>
let az=0.8, el=0.4, radius=3.0, t=[0,0,0], o=[0,0,0], busy=false, dirty=true;
let moving=false, restTimer=null;
const img=document.getElementById('v');
const modeEl=document.getElementById('mode'), qEl=document.getElementById('q');
function fps(){ return modeEl.value==='first-person'; }
function eye(){
  if(fps()) return o;
  const ce=Math.cos(el);
  return [t[0]+radius*ce*Math.cos(az), t[1]+radius*Math.sin(el),
          t[2]+radius*ce*Math.sin(az)];
}
function tgt(){
  if(!fps()) return t;
  const ce=Math.cos(el);
  return [o[0]+ce*Math.cos(az), o[1]+Math.sin(el), o[2]+ce*Math.sin(az)];
}
function fetchFrame(final){
  if(busy||!dirty) return; busy=true; dirty=false;
  const e=eye(), g=tgt();
  const q= final? 1.0 : parseFloat(qEl.value);
  img.src='/render?ox='+e[0]+'&oy='+e[1]+'&oz='+e[2]
         +'&tx='+g[0]+'&ty='+g[1]+'&tz='+g[2]+'&q='+q
         +'&layers='+(document.getElementById('layers').checked?1:0)
         +'&t='+Date.now();
  clearTimeout(restTimer);
  if(!final) restTimer=setTimeout(()=>{dirty=true;fetchFrame(true);},350);
}
img.onload=()=>{busy=false; fetchFrame();};
img.onerror=()=>{busy=false;};
let drag=false, pan=false, lx=0, ly=0;
img.oncontextmenu=e=>e.preventDefault();
img.onmousedown=e=>{drag=true; pan=(e.button===2||e.shiftKey);
  lx=e.clientX; ly=e.clientY;};
window.onmouseup=()=>{drag=false;};
window.onmousemove=e=>{ if(!drag) return;
  const dx=(e.clientX-lx), dy=(e.clientY-ly); lx=e.clientX; ly=e.clientY;
  if(pan){  // translate target/origin in the view plane
    const ce=Math.cos(el), f=[ce*Math.cos(az),Math.sin(el),ce*Math.sin(az)];
    const r=[ -f[2],0,f[0] ], n=Math.hypot(r[0],r[2])||1;
    r[0]/=n; r[2]/=n;
    const up=[ -f[1]*f[0], f[0]*f[0]+f[2]*f[2], -f[1]*f[2] ];
    const un=Math.hypot(up[0],up[1],up[2])||1;
    const s=0.002*radius;
    const tg=fps()? o : t;
    tg[0]+=-dx*s*r[0]+dy*s*up[0]/un; tg[1]+=dy*s*up[1]/un;
    tg[2]+=-dx*s*r[2]+dy*s*up[2]/un;
  } else {
    az+=dx*0.01*(fps()?-1:1); el+=dy*0.01*(fps()?1:-1);
    if(modeEl.value==='turntable'||fps())
      el=Math.max(-1.45,Math.min(1.45,el));
  }
  dirty=true; fetchFrame(); };
img.onwheel=e=>{e.preventDefault(); radius*=Math.exp(e.deltaY*0.001);
  dirty=true; fetchFrame();};
window.onkeydown=e=>{ if(!fps()) return;
  const ce=Math.cos(el), f=[ce*Math.cos(az),Math.sin(el),ce*Math.sin(az)];
  const r=[-f[2],0,f[0]], n=Math.hypot(r[0],r[2])||1, s=0.1;
  const k=e.key.toLowerCase();
  if(k==='w'){o[0]+=s*f[0];o[1]+=s*f[1];o[2]+=s*f[2];}
  if(k==='s'){o[0]-=s*f[0];o[1]-=s*f[1];o[2]-=s*f[2];}
  if(k==='a'){o[0]-=s*r[0]/n;o[2]-=s*r[2]/n;}
  if(k==='d'){o[0]+=s*r[0]/n;o[2]+=s*r[2]/n;}
  if(k==='q'){o[1]+=s;} if(k==='e'){o[1]-=s;}
  dirty=true; fetchFrame(); };
modeEl.onchange=()=>{ if(fps()){ const ey=eye(); o=[ey[0],ey[1],ey[2]];
    az+=Math.PI; el=-el; } dirty=true; fetchFrame(); };
document.getElementById('layers').onchange=()=>{dirty=true;fetchFrame();};
qEl.onchange=()=>{dirty=true;fetchFrame();};
setInterval(fetchFrame,100); fetchFrame();
</script></body></html>"""

def orbit_origin(theta: float, phi: float, radius: float):
    """Camera position of the orbit (azimuth ``theta``, elevation ``phi``)
    around the origin."""
    return (radius * np.cos(phi) * np.cos(theta), radius * np.sin(phi),
            radius * np.cos(phi) * np.sin(theta))


def encode_jpeg(frame: np.ndarray, width: int, height: int,
                quality: int = 85) -> bytes:
    """A [h, w, 3] frame in [0, 1] as JPEG bytes of ``width`` x ``height``
    (a reduced-quality frame is upscaled bilinearly)."""
    from PIL import Image
    img = Image.fromarray(np.clip(frame * 255, 0, 255).astype(np.uint8))
    if frame.shape[0] != height or frame.shape[1] != width:
        img = img.resize((width, height), Image.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format='JPEG', quality=quality)
    return buf.getvalue()


class ViewerServer:
    """Serves an interactive viewer of a trace function.

    Args:
        trace_fn: (rays, generator) -> {'rgb': [N, 3], 'depth': ...}, or
            None with ``frame_fn``.
        camera: frame size, fov and clip planes.
        port: TCP port; 0 picks a free one (``port`` holds it once bound).
        layers: optional {name: PrimitivesPack}, composited when the client
            enables them.
        stats_fn: () -> {group: {key: value}}, extra stat panels.
        frame_fn: () -> (trace_fn, iteration), called once a frame under
            ``lock``.
        lock: the lock frames render under (default: a new ``RLock``).
        device: where frames render (default: the card; ``'cpu'``
            explicitly).
    """

    def __init__(self, trace_fn: Optional[Callable] = None,
                 camera: CameraConfig = CameraConfig(width=256, height=256),
                 port: int = 8008,
                 layers: Optional[Dict[str, object]] = None,
                 stats_fn: Optional[Callable] = None,
                 frame_fn: Optional[Callable] = None, lock=None,
                 device=None):
        if (trace_fn is None) == (frame_fn is None):
            raise ValueError('pass trace_fn or frame_fn')
        self.trace_fn = trace_fn
        self.frame_fn = frame_fn
        self.camera = camera
        self.port = port
        self.layers = layers or {}
        self.stats_fn = stats_fn
        self.lock = lock if lock is not None else threading.RLock()
        self.device = device
        self._frame_ms = 0.0
        self._server = None
        self._thread = None
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, ctype: str, body: bytes, headers=()):
                self.send_response(200)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == '/':
                    page = (_PAGE.replace('__W__', str(viewer.camera.width))
                            .replace('__H__', str(viewer.camera.height)))
                    self._send('text/html', page.encode())
                elif url.path == '/render':
                    try:
                        body, headers = viewer._render_request(
                            parse_qs(url.query))
                    except Exception as e:   # the server keeps serving
                        log.exception('viewer frame failed')
                        self.send_error(500, f'frame failed: {e!r}')
                        return
                    self._send('image/jpeg', body, headers)
                elif url.path == '/stats':
                    self._send('application/json',
                               json.dumps(viewer.stats()).encode())
                else:
                    self.send_response(404)
                    self.end_headers()

        self._handler = Handler

    # ------------------------------------------------------------------
    def _render_request(self, q: dict):
        """JPEG bytes and headers of one ``/render`` query."""
        def get(name, default):
            return float(q.get(name, [default])[0])
        if 'ox' in q:
            origin = (get('ox', 0), get('oy', 0), get('oz', 3))
            target = (get('tx', 0), get('ty', 0), get('tz', 0))
        else:
            origin = orbit_origin(get('theta', 0.8), get('phi', 0.4),
                                  get('radius', 3.0))
            target = (0.0, 0.0, 0.0)
        frame, iteration = self.render_frame_at(
            origin, target, scale=get('q', 1.0),
            with_layers=q.get('layers', ['0'])[0] == '1',
            return_iteration=True)
        headers = [('X-Frame-Ms', f'{self._frame_ms:.3f}')]
        if iteration is not None:
            headers.append(('X-Iteration', str(iteration)))
        return (encode_jpeg(frame, self.camera.width, self.camera.height),
                headers)

    def stats(self) -> dict:
        """Grouped stat panels: those of ``stats_fn`` (a failing one reports
        its error) and the renderer's (frame time, resolution, device
        memory)."""
        out = {}
        if self.stats_fn is not None:
            try:
                out.update(self.stats_fn())
            except Exception as e:           # a panel only reports
                out['optimization'] = {'error': repr(e)}
        rend = {'frame_ms': round(self._frame_ms, 1),
                'resolution': f'{self.camera.width}x{self.camera.height}'}
        dev = torch.device(self.device) if self.device is not None \
            else torch.device('cuda')
        if dev.type == 'cuda' and torch.cuda.is_available():
            rend['device'] = torch.cuda.get_device_name(dev)
            rend['mem_in_use_mb'] = round(
                torch.cuda.memory_allocated(dev) / 1e6, 1)
            rend['mem_peak_mb'] = round(
                torch.cuda.max_memory_allocated(dev) / 1e6, 1)
        else:
            rend['device'] = str(dev)
        out['renderer'] = rend
        return out

    def render_frame_at(self, origin, target, scale: float = 1.0,
                        with_layers: bool = False,
                        return_iteration: bool = False):
        """The [h, w, 3] frame of a lookat camera; ``scale`` < 1 renders at
        that fraction of the resolution (at least 16 pixels a side).  With
        ``return_iteration``, also the training iteration it shows (None
        without ``frame_fn``)."""
        cam = self.camera
        if scale < 1.0:
            cam = CameraConfig(
                width=max(16, int(cam.width * scale)),
                height=max(16, int(cam.height * scale)),
                fov=cam.fov, dist_min=cam.dist_min, dist_max=cam.dist_max)
        ro, rd = lookat_rays(origin, target, cam)
        t0 = time.perf_counter()
        with self.lock, torch.no_grad():
            if self.frame_fn is not None:
                trace_fn, iteration = self.frame_fn()
            else:
                trace_fn, iteration = self.trace_fn, None
            out = render_rays(trace_fn, ro, rd, cam, device=self.device)
        self._frame_ms = (time.perf_counter() - t0) * 1e3
        frame = out['rgb'].reshape(cam.height, cam.width, 3)
        if with_layers and self.layers:
            from shacira_tpu_torch.render.overlay import (PinholeCamera,
                                                          draw_layers)
            pc = PinholeCamera.from_lookat(origin, target, cam)
            depth = out.get('depth')
            if depth is not None:
                depth = depth.reshape(cam.height, cam.width)
            frame = draw_layers(frame, pc, self.layers, depth=depth)
        return (frame, iteration) if return_iteration else frame

    def render_frame(self, theta: float, phi: float,
                     radius: float) -> np.ndarray:
        """The frame of the orbit camera (``theta``, ``phi``, ``radius``)."""
        return self.render_frame_at(orbit_origin(theta, phi, radius),
                                    (0.0, 0.0, 0.0))

    def render_jpeg_at(self, origin, target, scale: float = 1.0,
                       with_layers: bool = False) -> bytes:
        frame = self.render_frame_at(origin, target, scale, with_layers)
        return encode_jpeg(frame, self.camera.width, self.camera.height)

    def render_jpeg(self, theta: float, phi: float, radius: float) -> bytes:
        return self.render_jpeg_at(orbit_origin(theta, phi, radius),
                                   (0.0, 0.0, 0.0))

    def _bind(self):
        if self._server is None:
            self._server = ThreadingHTTPServer(('0.0.0.0', self.port),
                                               self._handler)
            self.port = self._server.server_address[1]

    def serve_forever(self):
        self._bind()
        print(f'viewer at http://localhost:{self.port}/')
        self._server.serve_forever()

    def start_background(self) -> threading.Thread:
        """Bind (``port`` is then the bound one) and serve on a daemon
        thread, once: a second call returns the serving thread."""
        if self._thread is None:
            self._bind()
            print(f'viewer at http://localhost:{self.port}/')
            self._thread = threading.Thread(
                target=self._server.serve_forever, daemon=True)
            self._thread.start()
        return self._thread

    def shutdown(self):
        """Stop serving and close the socket."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
