"""Kernel B1 on the SDF path: NeuralSDF's hash-grid backward.

No JAX import: the ``cuda`` tests run on the card's machine with
``python -m pytest --noconftest -m cuda tests/test_torch_sdf_kernel.py``.
On the CPU: an SDF step scatters its table gradient with one
``scatter_add`` per loss LOD, at the demo's shapes (4096 points x 5 LODs x
8 corners = 163,840 rows of F = 4 into the 15,761-row table), and the
normals of a render (a gradient for the coordinates alone) scatter
nothing.  On the card: B1 on a real SDF step's backward against its plain
version within 1e-5 of the largest sum, and one SDF step on the card
against the same step on the CPU (parameters within 1e-5)."""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
from shacira_tpu_torch.apps import sdf_demo  # noqa: E402
from shacira_tpu_torch.ops import hashgrid, scatter  # noqa: E402
from shacira_tpu_torch.ops.differential import autodiff_gradient  # noqa: E402
from shacira_tpu_torch.models.nefs.sdf import neural_sdf  # noqa: E402
from shacira_tpu_torch import optim  # noqa: E402

REL_TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the test
    workers share the machine's cores, and OpenMP regions over small
    tensors stall when their threads outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.fixture(scope='module')
def dataset():
    return sdf_demo.build_dataset()


def _recorded_scatters(monkeypatch):
    calls = []
    plain = scatter.scatter_add

    def recording(idx, vals, table_size):
        calls.append((idx.detach().clone(), vals.detach().clone(),
                      table_size))
        return plain(idx, vals, table_size)

    # the hash encode's backward calls the name it imported
    monkeypatch.setattr(hashgrid, 'scatter_add', recording)
    return calls


def _sdf_step_scatter(monkeypatch, ds, device, loss_lods=(4,)):
    """The scatter inputs of one demo-config SDF step on ``device``."""
    calls = _recorded_scatters(monkeypatch)
    tr = sdf_demo.build_trainer(ds, device=device)
    coords, sdfs = tr.draw_chunk(1)
    tr.step(coords[0], sdfs[0], tr.lod_masks(loss_lods))
    return tr, calls


def test_sdf_step_scatters_once_per_loss_lod(monkeypatch, dataset):
    for lods in ((4,), (2, 4)):
        _, calls = _sdf_step_scatter(monkeypatch, dataset, 'cpu', lods)
        assert [(i.shape[0], v.shape[1], t) for i, v, t in calls] == \
            [(4096 * 5 * 8, 4, 15761)] * len(lods)
        assert all(int(i.min()) >= 0 and int(i.max()) < 15761
                   for i, _, _ in calls)


def test_render_normals_scatter_nothing(monkeypatch, dataset):
    calls = _recorded_scatters(monkeypatch)
    tr = sdf_demo.build_trainer(dataset, device='cpu')
    x = torch.rand((64, 3)) * 2 - 1
    params = optim.tree_map(torch.Tensor.detach, tr.params)
    g = autodiff_gradient(lambda c: neural_sdf(params, tr.model_cfg, c), x)
    assert g.shape == (64, 3) and g.abs().sum() > 0
    assert calls == []
    tr.render(res=(8, 8))
    assert calls == []


@pytest.mark.cuda
def test_scatter_kernel_matches_plain_at_the_sdf_step(cuda_device,
                                                      monkeypatch, dataset):
    _, calls = _sdf_step_scatter(monkeypatch, dataset, cuda_device)
    (idx, vals, rows), = calls
    assert rows == 15761 and idx.shape[0] == 163_840
    got = scatter.scatter_add(idx, vals, rows)
    want = scatter.scatter_add_plain(idx, vals, rows)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= REL_TOL * float(want.abs().max()), err


@pytest.mark.cuda
def test_sdf_step_on_card_matches_cpu(cuda_device, dataset):
    params = {}
    for dev in ('cpu', cuda_device):
        tr = sdf_demo.build_trainer(dataset, device='cpu')
        start = optim.tree_map(lambda t: t.detach().to(dev), tr.params)
        tr = sdf_demo.build_trainer(dataset, device=dev)
        tr.set_params(start)
        rows = np.random.RandomState(0).randint(0, dataset.pool_size, 4096)
        coords = torch.as_tensor(dataset.coords[rows], device=dev)
        sdfs = torch.as_tensor(dataset.sdf[rows], device=dev)
        for _ in range(2):
            tr.step(coords, sdfs, tr.lod_masks((2, 4)))
        params[str(dev)] = [t.detach().cpu() for _, t in
                            optim.tree_leaves_with_path(tr.params)]
    for got, want in zip(params[str(cuda_device)], params['cpu']):
        assert float((got - want).abs().max()) <= 1e-5
