"""Train while viewing: the interactive-optimization loop.

Port of ``shacira_tpu/render/optimization_app.py``: training runs on a
background thread and the web viewer (``render/web_viewer.py``) renders
every frame against the trainer's newest parameters, so the user watches
the field converge.

The JAX package renders an immutable snapshot of the parameters.  Here
Adam updates them in place and a prune rewrites the occupancy, so frames
and training share one lock: the trainer's ``step_lock``, which it holds
through each step and each prune and releases between them (a frame waits
for at most one step, not a chunk of ``chunk_size`` steps).  A frame reads
``trainer.iteration`` under that lock and reports it.

Usage:
    app = OptimizationApp.from_multiview(trainer, port=8008)
    app.run(num_iterations=...)    # trains; browse http://localhost:8008
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from shacira_tpu_torch.render.offline import CameraConfig
from shacira_tpu_torch.render.web_viewer import ViewerServer
from shacira_tpu_torch.tracers import rf_tracer


class OptimizationApp:
    """A chunked trainer coupled with the interactive viewer.

    Args:
        trainer: has ``train(num_iterations=, log_fn=)``, ``params``,
            ``iteration`` and ``step_lock``.
        make_trace_fn: params -> (rays, generator) -> buffer dict; called
            once a frame, under the lock, with the trainer's parameters.
        camera / port / layers / device: for :class:`ViewerServer`
            (``port`` 0 picks a free port: ``server.port``).
    """

    def __init__(self, trainer, make_trace_fn: Callable,
                 camera: CameraConfig = CameraConfig(width=256, height=256),
                 port: int = 8008, layers=None, device=None):
        self.trainer = trainer
        self.lock = trainer.step_lock
        self._last_entry = {}

        def frame_fn():
            return make_trace_fn(trainer.params), trainer.iteration

        def stats():
            opt = {k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in self._last_entry.items()}
            obj = {}
            mcfg = getattr(trainer, 'model_cfg', None)
            grid = getattr(mcfg, 'grid', None) if mcfg else None
            if grid is not None:
                obj['grid'] = type(grid).__name__
                obj['num_lods'] = grid.num_lods
                if hasattr(grid, 'spec'):
                    obj['table_rows'] = grid.spec.total_size
                obj['hash_layout'] = getattr(grid, 'hash_layout', 'xor')
            # the occupancy arrives with the training log entries: reading
            # it here would sync the card once a poll
            return {'optimization': opt, 'object': obj}

        self.server = ViewerServer(
            camera=camera, port=port, layers=layers, stats_fn=stats,
            frame_fn=frame_fn, lock=self.lock,
            device=device if device is not None else trainer.device)
        self._train_err = None

    @classmethod
    def from_multiview(cls, trainer, camera=CameraConfig(width=256,
                                                         height=256),
                       port: int = 8008, layers=None):
        """Viewer over a ``MultiviewTrainer``'s radiance field in eval mode:
        the codebook decoded once a frame (rounded latents), or an
        alternative backbone's eval mode, traced with the trainer's tracer
        config (``fine_mode='kernel'`` rendering as ``'deferred'``)."""
        tcfg = trainer.eval_tracer_cfg
        occ_cfg = trainer.model_cfg.occ_cfg

        def make_trace_fn(params):
            field_fn = trainer.eval_field_fn(params)

            def trace_fn(rays, generator):
                return rf_tracer.trace(field_fn, trainer.occ_state, occ_cfg,
                                       tcfg, rays, generator)
            return trace_fn

        return cls(trainer, make_trace_fn, camera, port, layers)

    def run(self, num_iterations: Optional[int] = None, log_fn=None):
        """Serve the viewer and train to completion; a training exception
        is raised here once the viewer has stopped."""
        self.server.start_background()

        def work():
            def capture(entry):
                self._last_entry = dict(entry)
                if log_fn:
                    log_fn(entry)

            try:
                self.trainer.train(num_iterations=num_iterations,
                                   log_fn=capture)
            except Exception as e:          # raised by run() after join
                self._train_err = e

        t = threading.Thread(target=work, daemon=True)
        t.start()
        try:
            t.join()
        finally:
            self.server.shutdown()
        if self._train_err is not None:
            raise self._train_err
        return self.trainer
