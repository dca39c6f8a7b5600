"""Traffic kind ``train``: the port's DaeMon training step, one batch of new
seeded token ids a step.

Set-up builds the step (``make_train_step(movement="daemon")``), its master,
moments and working copy from the seed's weights, and drives that same
object through the check's first steps, which also warm up every shape the
window uses; the window keeps stepping it.  Each step ends on the host
reading its loss.

The check: a plain float32 reference follows the first ``check_steps``
steps from the same weights and batches.  Read: each step's loss, the norm
of each leaf of the first gradient as AdamW takes it (the program's from its
first moment after one step: m / (1 - b1)), and the norm of each leaf's
change over the steps; a leaf's gap is |norm - reference norm| over the
larger of the reference's norm of that leaf and of the median leaf.
"""
from __future__ import annotations

import math
import time

import numpy as np

from bench.harness import common
from bench.harness.config import flatten, program_config, to_tree
from bench.harness.weights import draw_weights, generator, iter_weights, token_ids
from bench.reference import llama


class Kind:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.attempted = self.failed = 0

    def batches(self, gen):
        """Batches of ``batch`` rows of ``seq`` new ids, labels the next ids."""
        b, s = self.traffic["batch"], self.traffic["seq"]
        while True:
            ids = token_ids(gen, self.cfg["vocab_size"], (b, s + 1), self.device)
            yield {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous()}

    def setup(self):
        from repro_torch.core import movement as mv
        from repro_torch.launch import steps

        tr = self.traffic
        pcfg = program_config(self.cfg)
        mvcfg = common.movement_config(tr["movement"])
        master = to_tree(draw_weights(self.cfg, self.seed, self.device))
        self.state = mv.init_state(master)
        self.params = mv.working_copy(master, mvcfg)
        del master
        self.step = steps.make_train_step(pcfg, peak_lr=tr["peak_lr"],
                                          total_steps=tr["total_steps"], movement="daemon",
                                          movement_cfg=mvcfg)
        self.feed = self.batches(generator(self.seed, "batches", self.device))
        self.losses = []
        for k in range(tr["check_steps"]):
            self.losses.append(self._step())
            if k == 0:
                b1 = tr["adamw"]["b1"]
                self.grad = {p: float(m.double().norm()) / (1 - b1)
                             for p, m in flatten(self.state.adam.m).items()}
        master = flatten(self.state.master)
        self.change = {p: float((master[p] - x).double().norm())
                       for p, x in iter_weights(self.cfg, self.seed, self.device)}

    def _step(self) -> float:
        self.params, self.state, metrics = self.step(self.params, self.state, next(self.feed))
        return float(metrics["loss"])

    def window(self, seconds: float, tracer):
        steps = 0
        t0 = time.perf_counter()
        while True:
            with tracer.unit(step=steps):
                loss = self._step()
            steps += 1
            self.failed += not math.isfinite(loss)
            if time.perf_counter() - t0 >= seconds and not tracer.pending:
                break
        self.window_s = time.perf_counter() - t0
        self.attempted = self.steps = steps

    def end_to_end(self) -> dict:
        tokens = self.steps * self.traffic["batch"] * self.traffic["seq"]
        return {"train_tokens_per_s": tokens / self.window_s}

    def release(self):
        del self.params, self.state, self.step, self.feed
        common.free(self.device)

    def reference(self, numerics: str = "f32", half_batch: bool = False):
        """(losses, first gradient's leaf norms, change's leaf norms) of the
        reference over the first steps' weights and batches."""
        feed = self.batches(generator(self.seed, "batches", self.device))
        batches = [next(feed) for _ in range(self.traffic["check_steps"])]
        if half_batch:
            keep = self.traffic["batch"] // 2
            batches = [{k: v[:keep] for k, v in b.items()} for b in batches]
        master = draw_weights(self.cfg, self.seed, self.device)
        losses, grad = llama.train_steps(self.cfg, self.traffic, master, batches,
                                         llama.Numerics(numerics))
        change = {p: float((master[p] - x).double().norm())
                  for p, x in iter_weights(self.cfg, self.seed, self.device)}
        del master
        common.free(self.device)
        return {"losses": losses, "grad": grad, "change": change}

    def check(self) -> dict:
        self.ref = self.reference()
        return numbers({"losses": self.losses, "grad": self.grad, "change": self.change},
                       self.ref)


def counted(ref: dict) -> list:
    """Leaves whose reference gradient is more than a thousandth of the
    median leaf's: the others move under AdamW by round-off alone."""
    med = float(np.median(list(ref["grad"].values())))
    return [k for k, g in ref["grad"].items() if g > 1e-3 * med]


def numbers(side: dict, ref: dict) -> dict:
    """The numbers compared (``bench/limits``): the first step's loss gap, the
    mean over the counted leaves of the first gradient's norm gap and the
    worst counted leaf's change norm gap; and two kept as readings only, the
    worst leaf's gradient norm gap and the loss gap over every check step
    (PERF.md gives why neither can hold a limit)."""
    keep = counted(ref)
    grad = sorted(common.leaf_gap(side["grad"], ref["grad"], keep, k) for k in keep)
    return {
        "loss_gap": abs(side["losses"][0] - ref["losses"][0]),
        "grad_norm_gap": float(np.mean(grad)),
        "change_norm_gap": max(common.leaf_gap(side["change"], ref["change"], keep, k)
                               for k in keep),
        "grad_norm_gap_worst_leaf": grad[-1],
        "loss_gap_all_steps": max(abs(a - b) for a, b in zip(side["losses"], ref["losses"])),
    }
