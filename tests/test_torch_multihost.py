"""Two real processes: the port's trainers across a two-process gloo group.

The counterpart of ``tests/test_multihost.py``.  The test starts this file
twice as a script (the worker is under ``__main__`` below); the two
processes join through ``multihost.initialize('127.0.0.1:<port>', 2,
pid)``, each builds the global mesh, loads its part of every batch and
trains; process 0 writes the parameters.  They must equal one process's
run within ``tests/test_parallel.py``'s 5e-3.  The image trainer runs
full-image mode; the NeRF trainer the paged trace on a sphere's occupancy
with ample budgets, each process tracing its rays at budgets/2.

Usage of the worker: python tests/test_torch_multihost.py <pid> <nproc>
<port> <out.pkl> <image|nerf>
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120              # then both workers are killed


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _trainer(mode, mesh=None):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_parallel as tp
    if mode == 'image':
        return tp.image_trainer('full', mesh)
    return tp.nerf_trainer('paged', mesh)


def _train(tr, mode):
    if mode == 'image':
        tr.train(finalize=False)
    else:
        tr.train(num_iterations=8)


def _host_params(tr):
    from shacira_tpu_torch import optim
    return {'/'.join(p): t.detach().numpy()
            for p, t in optim.tree_leaves_with_path(tr.params)}


def worker(pid, nproc, port, out, mode):
    from shacira_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    multihost.initialize(f'127.0.0.1:{port}', nproc, pid, backend='gloo',
                         timeout_s=WAIT_S)
    try:
        mesh = multihost.global_mesh()
        assert (mesh.rank, mesh.size) == (pid, nproc), mesh
        tr = _trainer(mode, mesh)
        _train(tr, mode)
        if mode == 'nerf':
            assert tr._shard_ray_active, 'each process traces its rays'
        params = _host_params(tr)
    finally:
        torch.distributed.destroy_process_group()
    if pid == 0:
        with open(out, 'wb') as f:
            pickle.dump(params, f)
    print(f'worker {pid}: {mode} done', flush=True)


@pytest.mark.parametrize('mode', ['image', 'nerf'])
def test_two_processes_match_one(tmp_path, mode):
    port, out = _free_port(), str(tmp_path / 'params.pkl')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(pid), '2',
         str(port), out, mode], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = _trainer(mode)
        _train(tr, mode)
        want = _host_params(tr)
        outs = []
        for p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, log) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'worker {pid} failed:\n{log}'
    with open(out, 'rb') as f:
        got = pickle.load(f)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=5e-3, atol=5e-3,
                                   err_msg=k)


def test_initialize_without_a_gpu(monkeypatch):
    import torch.distributed as dist
    from shacira_tpu_torch.parallel import multihost
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    multihost.initialize('127.0.0.1:1', 1, 0)          # one process: no-op
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match='CUDA'):    # NCCL, no fall-back
        multihost.initialize('127.0.0.1:1', 2, 0)
    with pytest.raises(ValueError, match='backend'):
        multihost.initialize('127.0.0.1:1', 2, 0, backend='mpi')
    assert not dist.is_initialized()


@pytest.mark.parametrize('addr, pid, local_rank, want', [
    (None, None, '2', (2, 'env://', -1)),        # torchrun's environment
    ('host:5', 5, None, (1, 'tcp://host:5', 5)),  # GPU pid mod 4
    ('file:///x', 3, '0', (0, 'file:///x', 3)),
    (None, None, None, ValueError)])
def test_initialize_chooses_the_gpu(monkeypatch, addr, pid, local_rank,
                                    want):
    """NCCL's set-up with the GPU calls recorded (4 GPUs)."""
    from shacira_tpu_torch.parallel import multihost
    calls = {}
    monkeypatch.setattr(multihost, 'resolve_device', lambda d: None)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    monkeypatch.setattr(torch.cuda, 'set_device',
                        lambda d: calls.update(device=d))
    monkeypatch.setattr(multihost.dist, 'init_process_group',
                        lambda backend, **k: calls.update(backend=backend, **k))
    if local_rank is None:
        monkeypatch.delenv('LOCAL_RANK', raising=False)
    else:
        monkeypatch.setenv('LOCAL_RANK', local_rank)
    if want is ValueError:
        with pytest.raises(ValueError, match='LOCAL_RANK'):
            multihost.initialize(addr, 4, pid)
        return
    multihost.initialize(addr, 4, pid, timeout_s=7)
    assert calls['backend'] == 'nccl'
    assert (calls['device'], calls['init_method'], calls['rank']) == want
    assert calls['world_size'] == 4
    assert calls['timeout'].total_seconds() == 7


if __name__ == '__main__':
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
           sys.argv[5])
