"""The port's web viewer and train-while-viewing app on the CPU, over HTTP
on a free port (``port=0``), mirroring tests/test_render_logging.py's
viewer and OptimizationApp tests: JPEG frames, a frame equal to
``render_rays`` of the same parameters, the quality knob, the overlay
layers, ``/stats``, a failed frame as an HTTP error, training while frames
are fetched, and frames that never see a half-applied step."""
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from shacira_tpu_torch.core import colors  # noqa: E402
from shacira_tpu_torch.core.primitives import (  # noqa: E402
    PrimitivesPack, axes_gizmo, occupancy_wireframe)
from shacira_tpu_torch.render import offline  # noqa: E402
from shacira_tpu_torch.render.optimization_app import (  # noqa: E402
    OptimizationApp)
from shacira_tpu_torch.render.web_viewer import ViewerServer  # noqa: E402
from shacira_tpu_torch.tracers import rf_tracer  # noqa: E402
from shacira_tpu_torch.trainers import multiview_trainer as tmt  # noqa: E402

from tests.test_torch_step import TRAIN, _cfgs, _scene  # noqa: E402

JPEG = b'\xff\xd8'


def _get(server, path):
    """(body, headers) of a GET on the server's bound port."""
    with urllib.request.urlopen(f'http://127.0.0.1:{server.port}{path}',
                                timeout=60) as r:
        return r.read(), r.headers


def _sphere(rays, generator):
    o, d = rays.origins, rays.dirs
    b = torch.sum(o * d, -1)
    disc = b * b - (torch.sum(o * o, -1) - 0.25)
    hit = disc > 0
    t = -b - torch.sqrt(torch.clamp(disc, min=0))
    return {'rgb': torch.where(hit[:, None], 0.3, 1.0) * torch.ones_like(o),
            'depth': torch.where(hit, t, 0.0)[:, None]}


def test_viewer_http_roundtrip():
    v = ViewerServer(_sphere, offline.CameraConfig(width=16, height=16),
                     port=0, device='cpu')
    assert v.render_frame(0.5, 0.3, 3.0).shape == (16, 16, 3)
    assert v.render_jpeg(0.5, 0.3, 3.0)[:2] == JPEG
    v.start_background()
    try:
        assert v.port != 0
        html, _ = _get(v, '/')
        assert b'shacira_tpu_torch viewer' in html
        assert b'first-person' in html and b'trackball' in html
        jpg, headers = _get(v, '/render?theta=0&phi=0&radius=3')
        assert jpg[:2] == JPEG and 'X-Iteration' not in headers
        assert float(headers['X-Frame-Ms']) > 0
        v.stats_fn = lambda: {'optimization': {'epoch': 3, 'psnr': 21.5}}
        stats = json.loads(_get(v, '/stats')[0])
        assert stats['optimization']['epoch'] == 3
        assert stats['renderer']['resolution'] == '16x16'
        assert stats['renderer']['device'] == 'cpu'
        v.stats_fn = lambda: 1 / 0            # a panel only reports
        assert 'error' in json.loads(_get(v, '/stats')[0])['optimization']
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(v, '/nothing')
        assert e.value.code == 404
        e.value.close()
    finally:
        v.shutdown()


def test_viewer_quality_layers_and_lookat():
    pack = PrimitivesPack()
    pack.add_lines([-0.5, 0.0, 0.0], [0.5, 0.0, 0.0], colors.red)
    v = ViewerServer(_sphere, offline.CameraConfig(width=32, height=32),
                     port=0, layers={'l': pack, 'axes': axes_gizmo(0.8)},
                     device='cpu')
    plain = v.render_frame_at((0, 0, 3), (0, 0, 0))
    over = v.render_frame_at((0, 0, 3), (0, 0, 0), with_layers=True)
    assert plain.shape == over.shape == (32, 32, 3)
    changed = np.any(plain != over, axis=-1)
    assert changed.any() and not changed.all()
    # the red line lies inside the sphere: hidden where the sphere covers
    # it, drawn beside it
    assert not np.any(over[16, 12:20, 0] > 0.9)
    quarter = v.render_frame_at((0, 0, 3), (0, 0, 0), scale=0.25)
    assert quarter.shape == (16, 16, 3)        # at least 16 a side
    half = v.render_frame_at((0, 0, 3), (0, 0, 0), scale=0.5)
    assert half.shape == (16, 16, 3)
    v.start_background()
    try:
        jpg, _ = _get(v, '/render?ox=0&oy=0&oz=3&tx=0&ty=0&tz=0&q=0.25'
                         '&layers=1')
        assert jpg[:2] == JPEG
        from PIL import Image
        import io
        assert Image.open(io.BytesIO(jpg)).size == (32, 32)   # upscaled
    finally:
        v.shutdown()


def test_failed_frame_is_an_http_error():
    def broken(rays, generator):
        raise ValueError('no field')

    v = ViewerServer(broken, offline.CameraConfig(width=8, height=8),
                     port=0, device='cpu')
    v.start_background()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(v, '/render?theta=0&phi=0&radius=3')
        assert e.value.code == 500
        e.value.close()
        assert json.loads(_get(v, '/stats')[0])['renderer']
    finally:
        v.shutdown()
    with pytest.raises(ValueError):
        ViewerServer(None, port=0, device='cpu')


def test_viewer_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    v = ViewerServer(_sphere, offline.CameraConfig(width=8, height=8),
                     port=0)
    with pytest.raises(RuntimeError, match='CUDA'):
        v.render_frame(0.5, 0.3, 3.0)


def _trainer(**cfg):
    _, tdata = _scene(num_views=4, res=12)
    *_, tm, tt, _ = _cfgs(max_samples=2048)
    tc = tmt.MultiviewTrainerConfig(**dict(TRAIN, **cfg))
    return tmt.MultiviewTrainer(tc, tm, tt, tdata, num_rays=32, seed=0,
                                device='cpu')


def test_frame_equals_render_rays_of_the_same_parameters():
    tr = _trainer(prune_every=4, chunk_size=2)
    tr.train(num_iterations=4)
    cam = offline.CameraConfig(width=12, height=10, fov=40.0,
                               dist_min=1.0, dist_max=4.2)
    app = OptimizationApp.from_multiview(tr, camera=cam, port=0)
    origin = (2.0, 0.8, 1.5)
    frame, iteration = app.server.render_frame_at(origin, (0, 0, 0),
                                                  return_iteration=True)
    assert iteration == 4
    field_fn = tr.eval_field_fn()
    ro, rd = offline.lookat_rays(origin, (0, 0, 0), cam)
    want = offline.render_rays(
        lambda rays, g: rf_tracer.trace(field_fn, tr.occ_state,
                                        tr.model_cfg.occ_cfg,
                                        tr.eval_tracer_cfg, rays, g),
        ro, rd, cam, device='cpu')['rgb'].reshape(10, 12, 3)
    np.testing.assert_array_equal(frame, want)
    assert float(np.std(frame)) > 0
    stats = app.server.stats()
    assert stats['object']['grid'] == 'LatentGridConfig'
    assert stats['object']['table_rows'] == tr.model_cfg.grid.spec.total_size


def test_optimization_app_trains_while_serving():
    """16 iterations in chunks of 4 with a prune at 8; a frame fetched over
    HTTP from the training thread's log at iteration 8 shows iteration 8,
    frames fetched from a client thread meanwhile show iterations in order,
    and one with the occupancy and axes layers is a JPEG too."""
    tr = _trainer(prune_every=8, chunk_size=4)
    layers = {'occupancy': occupancy_wireframe(tr.occ_state['occ'],
                                               max_cells=64),
              'axes': axes_gizmo(0.5)}
    app = OptimizationApp.from_multiview(
        tr, camera=offline.CameraConfig(width=8, height=8), port=0,
        layers=layers)
    frames, seen, stop = {}, [], threading.Event()

    def client():
        while not stop.is_set():
            body, headers = _get(app.server, '/render?theta=0.3&phi=0.2'
                                             '&radius=3&q=0.5&layers=1')
            seen.append((body[:2], int(headers['X-Iteration'])))

    c = threading.Thread(target=client, daemon=True)

    def poll(entry):
        if entry.get('iteration') == 8 and 'mid' not in frames:
            frames['mid'] = _get(app.server,
                                 '/render?theta=0&phi=0&radius=3')
        if entry.get('iteration') == 16:      # before run() stops serving
            stop.set()
            c.join(timeout=60)

    app.server.start_background()
    c.start()
    try:
        app.run(num_iterations=16, log_fn=poll)
    finally:
        stop.set()
        c.join(timeout=60)
    assert not c.is_alive()
    assert tr.iteration == 16
    body, headers = frames['mid']
    assert body[:2] == JPEG and headers['X-Iteration'] == '8'
    assert seen and all(magic == JPEG for magic, _ in seen)
    its = [k for _, k in seen]
    assert its == sorted(its) and all(0 <= k <= 16 for k in its)
    with pytest.raises(OSError):                # run() stopped the viewer
        _get(app.server, '/')


class _TornTrainer:
    """Steps write two parameters one after the other under the step lock,
    yielding in between: a frame outside the lock would see them differ."""

    def __init__(self):
        self.step_lock = threading.RLock()
        self.params = {'a': 0, 'b': 0}
        self.iteration = 0
        self.device = 'cpu'

    def train(self, num_iterations, log_fn=None):
        for it in range(1, num_iterations + 1):
            with self.step_lock:
                self.params['a'] = it
                time.sleep(0)
                self.params['b'] = it
                self.iteration = it
            time.sleep(0)


def test_frames_never_see_a_half_applied_step():
    tr = _TornTrainer()
    torn = []

    def make_trace_fn(params):
        a, b = params['a'], params['b']
        torn.append(a != b)

        def trace_fn(rays, generator):
            return {'rgb': torch.full_like(rays.origins, float(a == b))}
        return trace_fn

    app = OptimizationApp(tr, make_trace_fn,
                          camera=offline.CameraConfig(width=4, height=4),
                          port=0)
    stop = threading.Event()

    def client():
        while not stop.is_set():
            app.server.render_frame_at((0, 0, 3), (0, 0, 0))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    clients = [threading.Thread(target=client, daemon=True)
               for _ in range(8)]
    try:
        for c in clients:
            c.start()
        app.run(num_iterations=300)
    finally:
        stop.set()
        for c in clients:
            c.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(c.is_alive() for c in clients)
    assert len(torn) > 8 and not any(torn)


def test_a_training_error_is_raised_by_run():
    class Failing(_TornTrainer):
        def train(self, num_iterations, log_fn=None):
            raise FloatingPointError('diverged')

    app = OptimizationApp(Failing(), lambda p: _sphere, port=0)
    with pytest.raises(FloatingPointError, match='diverged'):
        app.run(num_iterations=4)
    with pytest.raises(OSError):
        _get(app.server, '/')


def test_fair_lock_hands_over_to_a_waiting_thread():
    """A thread that releases the lock and asks again at once queues
    behind a waiting one (threading.RLock lets it barge back in); the lock
    is reentrant, refuses a release by another thread, and a copy is a new
    free lock."""
    import copy
    from shacira_tpu_torch.utils.locks import FairRLock
    lock, got, stop = FairRLock(), [], threading.Event()

    def hog():
        while not stop.is_set():
            with lock:
                with lock:                      # reentrant
                    time.sleep(0.001)

    h = threading.Thread(target=hog, daemon=True)
    h.start()
    try:
        for _ in range(20):
            t0 = time.perf_counter()
            with lock:
                got.append(time.perf_counter() - t0)
    finally:
        stop.set()
        h.join(timeout=10)
    assert not h.is_alive()
    assert max(got) < 0.5                       # a hog turn is ~1 ms
    lock.acquire()
    other = threading.Thread(target=lambda: got.append(
        pytest.raises(RuntimeError, lock.release)))
    other.start()
    other.join(timeout=10)
    lock.release()
    assert copy.deepcopy(lock).acquire()
