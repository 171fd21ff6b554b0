"""The port's spans and counters where the work happens: the flat
compaction's sample counters (only a training step's, only while a
profiler records), the encode backward's range on autograd's side, the
trainer's prune, presample and log ranges, the octree grids' query,
gather and codebook-mix ranges and row counters, the dense trace's
integration range, and the operator's export of the counters beside the
trace.  CPU, tiny sizes, no JAX."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')
from shacira_tpu_torch.accel import occupancy as tocc  # noqa: E402
from shacira_tpu_torch.core.rays import make_rays  # noqa: E402
from shacira_tpu_torch.datasets.nerf_synthetic import (  # noqa: E402
    MultiviewData, pinhole_rays)
from shacira_tpu_torch.models.grids import latent_grid as tlg  # noqa: E402
from shacira_tpu_torch.models.grids import octree_grid as tog  # noqa: E402
from shacira_tpu_torch.models.nefs import nerf as tnerf  # noqa: E402
from shacira_tpu_torch.tracers import rf_tracer as trt  # noqa: E402
from shacira_tpu_torch.trainers import multiview_trainer as tmt  # noqa: E402
from shacira_tpu_torch.utils import perf  # noqa: E402

GRID = dict(feature_dim=2, num_lods=3, min_grid_res=4, max_grid_res=24,
            latent_dim=1, multiscale_type='cat', feature_std=0.3,
            codebook_bitwidth=9, entropy_enabled=True, num_prob_layers=1)
LDEC = dict(ldec_std=0.1, use_shift=True, use_sga=True, diff_sampling=True)
RAYS, STEPS, BUDGET = 64, 64, 1000       # ~2,100 live samples: overflow
COUNTERS = ('trace/live_samples', 'trace/kept_samples', 'trace/slots')
STEP_KW = dict(ent_lambda=1e-3, temperature=1.0, lr_ldec=1e-2, use_sga=True)


def _views(num_views=4, res=16):
    """A white sphere of radius 0.5 seen from a circle of cameras."""
    rgbs, origins, dirs = [], [], []
    for v in range(num_views):
        th = 2 * np.pi * v / num_views
        cam = np.asarray([2.5 * np.cos(th), 0.8, 2.5 * np.sin(th)],
                         np.float32)
        fwd = -cam / np.linalg.norm(cam)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1] = right, np.cross(right, fwd)
        c2w[:3, 2], c2w[:3, 3] = -fwd, cam
        o, d = pinhole_rays(c2w, res, res, res * 1.2, res * 1.2)
        b = np.sum(o * d, -1)
        hit = b * b - (np.sum(o * o, -1) - 0.25) > 0
        rgbs.append(np.where(hit[:, None], 0.8, 1.0).astype(np.float32)
                    * np.ones((1, 3), np.float32))
        origins.append(o)
        dirs.append(d)
    return MultiviewData(rgb=np.stack(rgbs), rays_o=np.stack(origins),
                         rays_d=np.stack(dirs),
                         masks=np.ones((num_views, res * res, 1), bool),
                         h=res, w=res, dist_min=1.0, dist_max=4.2)


def _trainer(**cfg):
    model = tnerf.NeuralRadianceFieldConfig(
        grid=tlg.LatentGridConfig.from_geometric(**GRID).with_ldec(LDEC),
        hidden_dim=16, view_embedder='positional', blas_level=3)
    train = dict(epochs=20, prune_every=-1, chunk_size=4, valid_views=1)
    train.update(cfg)
    return tmt.MultiviewTrainer(
        tmt.MultiviewTrainerConfig(**train), model,
        trt.RFTracerConfig(num_steps=STEPS, max_samples=BUDGET), _views(),
        num_rays=RAYS, seed=0, device='cpu')


def _batch(tr, use_sga: bool = True):
    ro, rd, gt = (torch.as_tensor(a[0]) for a in tr._presample(1))
    return ro, rd, gt, tr.draw_step(use_sga=use_sga)


def _live(tr, ro, rd, draws) -> int:
    """The step's live march samples, counted on its mask directly."""
    d = tr.dataset
    m = tocc.raymarch_ray(tr.occ_state, tr.model_cfg.occ_cfg,
                          make_rays(ro, rd, d.dist_min, d.dist_max), STEPS,
                          draws.march_u)
    return int(m['mask'].sum())


def test_a_profiled_step_counts_the_march_samples_and_the_budget():
    perf.reset_counts()
    tr = _trainer()
    ro, rd, gt, draws = _batch(tr)
    live = _live(tr, ro, rd, draws)
    assert live > BUDGET
    with torch.profiler.profile():
        tr.step(ro, rd, gt, draws, **STEP_KW)
    stride = math.ceil(live / BUDGET)
    assert perf.counted('trace/live_samples') == live
    assert perf.counted('trace/kept_samples') == math.ceil(live / stride)
    assert perf.counted('trace/slots') == BUDGET


def test_an_unprofiled_step_counts_nothing():
    perf.reset_counts()
    tr = _trainer()
    tr.step(*_batch(tr), **STEP_KW)
    assert perf._device == {}
    assert all(perf.counted(n) == 0.0 for n in COUNTERS)


def test_renders_and_validation_count_nothing():
    perf.reset_counts()
    tr = _trainer()
    with torch.profiler.profile():
        tr.render_view(0)
        tr.validate()
    assert perf._device == {}
    assert all(perf.counted(n) == 0.0 for n in COUNTERS)


def _below(event, name) -> bool:
    return any(ch.name.startswith(name) or _below(ch, name)
               for ch in event.cpu_children)


def test_the_encode_backward_is_a_range_over_its_scatter():
    tr = _trainer()
    batch = _batch(tr)
    with torch.profiler.profile() as prof:
        tr.step(*batch, **STEP_KW)
    ranges = [e for e in prof.events() if e.name == 'backward/encode']
    assert len(ranges) == 1
    # the table gradient's scatter (the plain version's accumulating put;
    # kernel B1 on the card)
    assert _below(ranges[0], 'aten::index_put_')
    assert not any(_below(e, 'backward/encode') for e in prof.events()
                   if e.name == 'field/encode')


def test_training_across_a_prune_shows_its_ranges():
    tr = _trainer(prune_every=2)
    log = []
    with torch.profiler.profile() as prof:
        tr.train(num_iterations=4, log_fn=log.append)
    names = [e.name for e in prof.events()]
    assert names.count('step/prune') == 2
    assert names.count('step/presample') == 2      # a chunk each
    assert names.count('step/log') == 2
    assert len(log) == 2 and tr.iteration == 4


def test_profile_writes_the_counters_beside_the_trace(tmp_path):
    tr = _trainer()
    perf.count('launches/elsewhere', 1)            # before the block
    with perf.trace_to(str(tmp_path)):
        tr.step(*_batch(tr), **STEP_KW)
    assert (tmp_path / 'trace.json').exists()
    counters = json.loads((tmp_path / 'counters.json').read_text())
    assert counters['trace/slots'] == BUDGET
    assert 0 < counters['trace/kept_samples'] <= BUDGET
    assert counters['trace/live_samples'] >= counters['trace/kept_samples']
    assert 'launches/elsewhere' not in counters


def _octree_trainer(kind: str):
    """NGLOD or VQAD on the dense 'ray' trace (no budget)."""
    base = dict(feature_dim=5, base_lod=2, num_lods=2, feature_std=0.01)
    grid = (tog.CodebookOctreeGridConfig(codebook_bitwidth=4, **base)
            if kind == 'codebook' else tog.OctreeGridConfig(**base))
    model = tnerf.NeuralRadianceFieldConfig(
        grid=grid, hidden_dim=16, view_embedder='positional', blas_level=3)
    return tmt.MultiviewTrainer(
        tmt.MultiviewTrainerConfig(epochs=20, prune_every=-1, chunk_size=4,
                                   valid_views=1),
        model, trt.RFTracerConfig(num_steps=STEPS, max_samples=0), _views(),
        num_rays=RAYS, seed=0, device='cpu')


OCTREE_KW = dict(ent_lambda=0.0, temperature=1.0, lr_ldec=0.0,
                 use_sga=False)


@pytest.mark.parametrize('kind', ['codebook', 'octree'])
def test_an_octree_step_names_its_query_gather_and_mix(kind):
    """The octree grids' spans inside the encode, their counters (every
    sample of the dense trace, 2 LODs, 8 corners), the gather's backward
    on autograd's side and the dense trace's integration and sample
    counters (every live sample kept, a slot for every sample)."""
    perf.reset_counts()
    tr = _octree_trainer(kind)
    batch = _batch(tr, use_sga=False)
    tr.step(*batch, **OCTREE_KW)                   # unprofiled: no counts
    assert perf._device == {}
    assert all(perf.counted(n) == 0.0
               for n in COUNTERS + ('field/corner_rows',))
    with torch.profiler.profile() as prof:
        tr.step(*batch, **OCTREE_KW)
    live = _live(tr, batch[0], batch[1], batch[3])
    assert 0 < live < RAYS * STEPS
    assert perf.counted('trace/live_samples') == live
    assert perf.counted('trace/kept_samples') == live
    assert perf.counted('trace/slots') == RAYS * STEPS
    assert perf.counted('field/corner_rows') == RAYS * STEPS * 2 * 8
    names = [e.name for e in prof.events()]
    assert names.count('field/octree_query') == 1
    assert names.count('field/gather') == 1
    # VQAD mixes and blends every LOD in one call
    assert names.count('field/codebook_mix') == (1 if kind == 'codebook'
                                                 else 0)
    assert names.count('trace/integrate') == 1
    encode = [e for e in prof.events() if e.name == 'field/encode']
    for span in ('field/octree_query', 'field/gather'):
        assert _below(encode[0], span), span
    ranges = [e for e in prof.events() if e.name == 'backward/encode']
    assert len(ranges) == 1 and _below(ranges[0], 'aten::index_put_')
    perf.reset_counts()


def test_an_octree_render_counts_nothing():
    perf.reset_counts()
    tr = _octree_trainer('codebook')
    with torch.profiler.profile():
        tr.render_view(0)
    assert all(perf.counted(n) == 0.0
               for n in COUNTERS + ('field/corner_rows',))
