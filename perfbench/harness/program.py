"""What the entries share: the program's arguments from the frozen
settings, a trainer cell's set-up, blocks and traced block
(:class:`TrainerCell`), the recorder of the steps the comparison reads
(:class:`Recorder`) and the comparison of training cells."""
from __future__ import annotations

import time
from typing import Dict

import torch

from perfbench.harness import compare, traffic, weights
from perfbench.harness.profile import profile_block
from perfbench.reference import common as C

# the settings a run sets itself: its seed and device, and no files
PER_RUN = ('config', 'device', 'seed', 'dataset_path')


def parse(parser, settings: dict, seed: int, device: str):
    """The program's parsed arguments: its parser's defaults under the
    frozen ``settings`` (a key the parser does not know raises)."""
    from shacira_tpu_torch import config as cfg_mod
    valid = {a.dest for g in parser._action_groups for a in g._group_actions}
    unknown = sorted(set(settings) - valid)
    if unknown:
        raise ValueError(f'settings the program does not know: {unknown}')
    parser.set_defaults(**{k: v for k, v in settings.items()
                           if k not in PER_RUN})
    parser.set_defaults(seed=seed, device=device)
    return cfg_mod.parse_args(parser, [])


def program_seed(seed: int) -> int:
    """The trainer's seed (its ``RandomState`` takes 32 bits)."""
    return seed % 2 ** 32


def clone(tree):
    return C.tree_map(lambda t: t.detach().clone(), tree)


def to(tree, device):
    """A copy of ``tree`` on ``device``."""
    return C.tree_map(lambda t: t.detach().to(device, copy=True), tree)


def trained_norms(tree, scale: float = 1.0) -> Dict[tuple, torch.Tensor]:
    """Device norms (float64) of the trained leaves of ``tree``."""
    return {p: torch.linalg.vector_norm(t.detach().double()) * scale
            for p, t in C.leaves(tree) if C.label(p) != 'frozen'}


def flat_norms(d: Dict[tuple, torch.Tensor]) -> Dict[tuple, float]:
    """Norms of the tensors of a {path: tensor} dict."""
    return {p: float(torch.linalg.vector_norm(t.detach().double()))
            for p, t in d.items()}


def diff_norms(a, b) -> Dict[tuple, torch.Tensor]:
    bl = dict(C.leaves(b))
    return {p: torch.linalg.vector_norm((t.detach() - bl[p].to(t.device))
                                        .double())
            for p, t in C.leaves(a) if C.label(p) != 'frozen'}


def floats(d: Dict[tuple, torch.Tensor]) -> Dict[tuple, float]:
    return {k: float(v) for k, v in d.items()}


def first_steps(prog: dict, ref: dict) -> Dict[str, float]:
    """The first steps' numbers: the worst step's loss gap, the worst
    leaf's gap of the first gradient Adam took and of the parameters'
    change after the steps (leaves the reference does not move left
    out)."""
    loss = max(compare.rel(prog['loss'][i], ref['loss'][i])
               for i in ref['loss'])
    grad, g_at = compare.worst_leaf(prog['g1'], ref['g1'])
    change, c_at = compare.worst_leaf(prog['change'], ref['change'],
                                      compare.moving(ref['g1']))
    return {'loss': loss, 'grad': grad, 'change': change,
            'grad_leaf': g_at, 'change_leaf': c_at}


class Recorder:
    """Wraps a trainer's methods named in ``WRAPS`` (the subclass's
    methods of the same names) and keeps what the comparison reads; it
    changes nothing they do.  Kept for every entry: the step's random
    draws named in ``DRAWS`` of the first ``steps`` steps, their losses,
    the norms of the first gradient Adam took (Adam's first moment after
    one step is (1 - b1) g) and of the change after ``steps`` steps."""
    WRAPS = ('step',)
    DRAWS = ()

    def __init__(self, trainer, p0: dict, steps: int):
        self.tr, self.p0, self.steps = trainer, p0, steps
        self.calls = 0
        self.draws, self.loss = {}, {}
        self.orig = {m: getattr(trainer, m) for m in self.WRAPS}
        for m in self.WRAPS:
            setattr(trainer, m, getattr(self, m))

    def detach(self):
        """Unwrap the trainer and let go of it."""
        for m in self.WRAPS:
            delattr(self.tr, m)
        self.tr = self.orig = self.p0 = None

    def keep_draws(self, it: int, draws):
        self.draws[it] = {k: getattr(draws, k).detach().clone()
                          for k in self.DRAWS
                          if getattr(draws, k) is not None}

    def stepped(self, it: int, out: dict):
        """Bookkeeping after the trainer's step ``it`` returned ``out``."""
        tr = self.tr
        if it <= self.steps:
            self.loss[it] = out['loss'].detach().clone()
        if it == 1:
            self.g1 = trained_norms(tr.opt_state['mu'], 1 / (1 - C.B1))
        if it == self.steps:
            self.change = diff_norms(tr.params, self.p0)

    def outputs(self) -> dict:
        """The program's numbers, on the host."""
        return {'loss': {i: float(v) for i, v in self.loss.items()},
                'g1': floats(self.g1), 'change': floats(self.change)}

    def to_host(self):
        """Recorded inputs off the card for the window."""
        self.draws = to(self.draws, 'cpu')


class TrainerCell:
    """One cell of a family of the program's trainers.  Set-up builds one
    trainer with the benchmark's weights (from the seed) and warms it
    through ``warmup_steps`` steps in blocks of ``block_steps`` (the
    harness block sizes of the configuration), a :class:`Recorder`
    keeping the steps the comparison reads on the way; the window runs
    whole blocks through the trainer's own ``train``.

    An entry gives ``FAMILY`` (the weights' tree), ``throughput`` (its
    end-to-end metric) and :meth:`build` (the program's trainer for the
    inputs), :meth:`recorder`, :meth:`checked_steps`, :meth:`train`,
    :meth:`rate`, :meth:`work`, :meth:`reference` and :meth:`readings`.
    """
    FAMILY = ''
    throughput = ''

    def __init__(self, root: str, config: dict, mix: dict, seed: int,
                 device: str):
        self.root = root
        self.s, self.h, self.mix = config['settings'], config['harness'], mix
        self.seed, self.device = seed, device
        self.pseed = program_seed(seed)

    def setup(self, only_checks: bool = False):
        """Build, load the weights and warm up (``only_checks``: only
        through the steps the comparison reads)."""
        t0 = time.perf_counter()
        # where the program is absent, fail before the inputs are made
        import shacira_tpu_torch  # noqa: F401
        self.inputs = traffic.make(self.root, self.mix, self.seed,
                                   self.device)
        t1 = time.perf_counter()
        tr = self.build()
        p0 = weights.make(self.s, self.FAMILY, self.seed * 2 + 1,
                          self.device)
        if not weights.same_layout(p0, tr.params):
            raise RuntimeError('the program\'s parameter tree is not the '
                               'configuration\'s')
        self.p0 = to(p0, 'cpu')
        tr.set_params(p0)
        t2 = time.perf_counter()
        rec = self.recorder(tr, to(self.p0, self.device))
        last = self.checked_steps() if only_checks \
            else self.h['warmup_steps']
        done = 0
        while done < last:
            n = min(self.h['block_steps'], last - done)
            self.train(tr, n)
            done += n
        rec.detach()
        rec.to_host()
        self.tr, self.rec = tr, rec
        if self.device == 'cuda':
            torch.cuda.synchronize()
        self.phases = {'inputs': t1 - t0, 'trainer': t2 - t1,
                       'warm-up': time.perf_counter() - t2}

    def block(self) -> int:
        self.train(self.tr, self.h['block_steps'])
        return self.h['block_steps']

    def trace(self):
        """The profiled block of ``trace_steps`` steps, after an
        unprofiled one of as many that times the step."""
        tr, n = self.tr, self.h['trace_steps']
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.train(tr, n)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / n
        before = self.before_trace()
        t = profile_block(lambda: self.train(tr, n), n)
        t.extra.update(self.work(before, n))
        t.extra['step_s'] = step_s
        return t

    def before_trace(self):
        """What :meth:`work` needs of the state the traced block starts
        from."""
        return None

    def free(self):
        """The program's numbers kept, its trainer and state freed."""
        self.prog = self.rec.outputs()
        del self.tr
