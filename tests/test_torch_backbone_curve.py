"""Loss curves of the alternative backbones in both packages.

The arguments and the training run of the JAX package's own multi-step test
(``tests/test_grid_backbones.py``: ``_args`` and ``_train_small``) go
through each package's config reader and ``MultiviewTrainer.train``, from
the same carried-over parameters.  The JAX trainer's draws -- its ray
batches and each step's march jitter -- are captured from its chunks and
handed to the port's trainer, so both see the same steps.  The two
``rgb_loss`` curves are compared step by step, over 10 steps here and
over the JAX test's 40 steps in the slow cases:

* with the head in float32 (``--disable-amp true``, the one flag added):
  within 1e-5 relative to the step's loss (float32 sums in another order;
  2.9e-7 measured over 40 steps);
* with the JAX test's arguments as they are, the NeRF head in bf16: within
  2e-2 relative (bf16 keeps 8 bits of mantissa, and XLA and PyTorch round
  the head's products and sums at different points; 1.2e-2 measured over
  40 steps).

OctreeGrid is the control (it learns on the card); CodebookOctreeGrid
(VQAD) and TriplanarGrid are the grids that stayed at the background on
the card at their YAMLs' widths.  All three learn here, alike in both
packages."""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')

from shacira_tpu import config as jconfig  # noqa: E402
from shacira_tpu.accel import occupancy as jocc  # noqa: E402
from shacira_tpu.tracers import rf_tracer as jrt  # noqa: E402
from shacira_tpu.trainers import multiview_trainer as jmt  # noqa: E402
from shacira_tpu.utils.rng import step_key  # noqa: E402
from shacira_tpu_torch import config as tconfig  # noqa: E402
from shacira_tpu_torch.datasets.nerf_synthetic import (  # noqa: E402
    MultiviewData as TData)
from shacira_tpu_torch.trainers import multiview_trainer as tmt  # noqa: E402
from shacira_tpu_torch.utils.convert import (  # noqa: E402
    adam_state_from_jax, params_from_jax)

from tests.test_nerf import synthetic_scene  # noqa: E402

GRID_TYPES = ('OctreeGrid', 'CodebookOctreeGrid', 'TriplanarGrid')
RTOL = {False: 1e-5, True: 2e-2}      # by amp (bf16 head)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers share the machine's cores, and OpenMP regions over small
    tensors stall when their threads outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _argv(grid_type, amp):
    """``tests/test_grid_backbones.py::_args``, without its platform."""
    return ['--grid-type', grid_type, '--disable-amp', str(not amp),
            '--feature-dim', '2', '--feature-std', '0.05',
            '--base-lod', '2', '--num-lods', '2',
            '--min-grid-res', '4', '--max-grid-res', '16',
            '--codebook-bitwidth', '4', '--blas-level', '3',
            '--hidden-dim', '16', '--num-steps', '32',
            '--prune-min-density', '1.0',
            '--epochs', '50', '--chunk-size', '10', '--prune-every', '-1',
            '--grid-lr', '0.05', '--log-every', '1']


def _jax_run(grid_type, amp, iters):
    """The JAX test's ``_train_small``: returns its initial params and
    Adam state, the per-step draws of its chunks and its per-step
    ``rgb_loss``."""
    args = jconfig.parse_args(
        jconfig.add_nerf_args(jconfig.build_image_parser()),
        _argv(grid_type, amp) + ['--platform', 'cpu'])
    data = synthetic_scene(num_views=6, res=16)
    tr = jmt.MultiviewTrainer(jconfig.build_nerf_trainer_config(args),
                              jconfig.build_nerf_model_config(args),
                              jconfig.build_tracer_config(args), data,
                              num_rays=128, seed=0)
    start = (jax.tree.map(np.array, tr.params),
             jax.tree.map(np.array, tr.opt_state))
    chunks, rays = [], []
    presample, chunk_fn = tr._presample, tr._get_chunk_fn

    def record_rays(n):
        out = presample(n)
        rays.append(out)
        return out

    def record_chunk(use_sga):
        run = chunk_fn(use_sga)

        def wrapped(params, opt_state, noise, occ_state, tables, xs):
            out = run(params, opt_state, noise, occ_state, tables, xs)
            chunks.append((xs['rng'], np.asarray(out[1]['rgb_loss'])))
            return out
        return wrapped

    tr._presample, tr._get_chunk_fn = record_rays, record_chunk
    losses = []
    tr.train(num_iterations=iters,
             log_fn=lambda e: losses.append(e['rgb_loss']))
    # the JAX test's view of the run: one logged loss per chunk
    assert losses == [float(c[1][-1]) for c in chunks]
    shape = jrt.march_jitter_shape(tr.tracer_cfg, tr.num_rays)
    impl = tr.cfg.rng_impl
    steps = []
    for (keys, _), (ro, rd, gt) in zip(chunks, rays):
        for i in range(len(ro)):
            _, _, k_march = jax.random.split(keys[i], 3)
            u = jocc.march_uniform(step_key(k_march, impl), shape)
            steps.append((ro[i], rd[i], gt[i], np.array(u)))
    curve = np.concatenate([c[1] for c in chunks])
    return start, steps, curve


def _port_run(grid_type, amp, start, steps):
    """The same run through the port's config reader and ``train``, its
    ray batches and march jitter taken from the JAX run."""
    args = tconfig.parse_args(tconfig.build_nerf_parser(),
                              _argv(grid_type, amp) + ['--device', 'cpu'])
    j = synthetic_scene(num_views=6, res=16)
    data = TData(rgb=j.rgb, rays_o=j.rays_o, rays_d=j.rays_d, masks=j.masks,
                 h=j.h, w=j.w, dist_min=j.dist_min, dist_max=j.dist_max)
    tr = tmt.MultiviewTrainer(tconfig.build_nerf_trainer_config(args),
                              tconfig.build_nerf_model_config(args),
                              tconfig.build_tracer_config(args), data,
                              num_rays=128, seed=0, device='cpu')
    params, opt = start
    tr.set_params(params_from_jax(params),
                  adam_state_from_jax(opt.mu, opt.nu, opt.count))
    queue = list(steps)
    taken, curve = [], []

    def presample(n):
        taken[:] = queue[:n]
        del queue[:n]
        return tuple(np.stack([s[k] for s in taken]) for k in range(3))

    draws = iter(s[3] for s in steps)
    step = tr.step

    def recorded_step(*a, **k):
        out = step(*a, **k)
        curve.append(float(out['rgb_loss']))
        return out

    tr._presample = presample
    tr.draw_step = lambda use_sga, refresh_noise=True: tmt.StepDraws(
        march_u=torch.as_tensor(next(draws)))
    tr.step = recorded_step
    tr.train(num_iterations=len(steps))
    assert not queue
    return np.asarray(curve)


def _compare(grid_type, iters, amp=False):
    start, steps, want = _jax_run(grid_type, amp, iters)
    got = _port_run(grid_type, amp, start, steps)
    assert got.shape == want.shape == (iters,)
    diverged = np.flatnonzero(np.abs(got - want) > RTOL[amp] * np.abs(want))
    assert diverged.size == 0, (
        f'{grid_type}: the curves part at step {diverged[0] + 1}: port '
        f'{got.tolist()}, JAX {want.tolist()}')
    return got, want


@pytest.mark.parametrize('amp', [False, True], ids=['f32', 'bf16'])
@pytest.mark.parametrize('grid_type', GRID_TYPES)
def test_backbone_loss_curve_matches_jax(grid_type, amp):
    _compare(grid_type, 10, amp)


@pytest.mark.slow
@pytest.mark.parametrize('amp', [False, True], ids=['f32', 'bf16'])
@pytest.mark.parametrize('grid_type', GRID_TYPES)
def test_backbone_loss_curve_matches_jax_over_the_jax_test(grid_type, amp):
    """The JAX test's 40 steps, and its own check: the last loss below the
    first, in both packages."""
    got, want = _compare(grid_type, 40, amp)
    assert got[-1] < got[0] and want[-1] < want[0], (got, want)
