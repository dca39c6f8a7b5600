"""Traffic kind ``decode_sessions``: sessions whose history is prefilled in
set-up into a cache of ``slots`` positions (``make_prefill_step``, then
``launch.serve._grow_cache``); in the window, turn after turn, each session
is fed one new token at position ``history`` and decodes ``turn_tokens``
greedily (``make_decode_step``), every turn over the same history: decode
masks the slots past its position, so what a turn wrote is never read by
the next.  The host is not synchronised between decode steps.

The check: a sample of the finished requests (a session's turn) drawn from
the seed is run through the float32 reference, history, fed token and served
tokens together; the number is the widest gap by which a served token's
reference logit lies below the reference's best at its position.  When the
window closes before a turn has finished, that turn runs on to its end after
the window, untimed.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from bench.harness import common
from bench.harness.config import program_config, to_tree
from bench.harness.weights import draw_weights, generator, stream_seed, token_ids
from bench.reference import llama


class Kind:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.attempted = self.failed = 0

    def setup(self):
        from repro_torch.core import movement as mv
        from repro_torch.launch import steps
        from repro_torch.launch.serve import _grow_cache

        tr, v = self.traffic, self.cfg["vocab_size"]
        pcfg = program_config(self.cfg)
        mvcfg = common.movement_config(tr["movement"])
        self.params = to_tree(draw_weights(self.cfg, self.seed, self.device,
                                           then=lambda x: mv.working_copy(x, mvcfg)))
        self.decode = steps.make_decode_step(pcfg)
        self.history = token_ids(generator(self.seed, "history", self.device), v,
                                 (tr["sessions"], tr["history"]), self.device)
        _, cache = steps.make_prefill_step(pcfg)(self.params, {"tokens": self.history})
        self.cache = _grow_cache(pcfg, cache, tr["slots"])
        del cache
        common.free(self.device)
        warm = token_ids(generator(self.seed, "warm-up", self.device), v, (tr["sessions"],),
                         self.device)
        for i in range(2):
            warm, _, self.cache = self.decode(self.params, self.cache, warm, tr["history"] + i)
        common.sync(self.device)

    def _turn(self, tokens, first: int, last: int, out: list, tracer=None, stop_at=None):
        """Decode steps ``first`` .. ``last - 1`` of a turn from ``tokens``;
        returns (the last token, whether the window's time ran out)."""
        pos0 = self.traffic["history"]
        for i in range(first, last):
            if tracer is None:
                tokens, _, self.cache = self.decode(self.params, self.cache, tokens, pos0 + i)
            else:
                with tracer.unit(step=i), record_function("bench.decode_step"):
                    tokens, _, self.cache = self.decode(self.params, self.cache, tokens, pos0 + i)
            out.append(tokens)
            self.steps += tracer is not None
            if stop_at is not None and time.perf_counter() >= stop_at and not tracer.pending:
                return tokens, True
        return tokens, False

    def window(self, seconds: float, tracer):
        tr = self.traffic
        gen = generator(self.seed, "turns", self.device)
        self.turns, self.steps = [], 0  # (fed tokens, served tokens (sessions, turn_tokens))
        t0 = time.perf_counter()
        while True:
            fed = token_ids(gen, self.cfg["vocab_size"], (tr["sessions"],), self.device)
            self.attempted += tr["sessions"]
            out = []
            tok, ended = self._turn(fed, 0, tr["turn_tokens"], out, tracer, t0 + seconds)
            if len(out) == tr["turn_tokens"]:
                self.turns.append((fed.cpu(), torch.stack(out, dim=1).cpu()))
            if ended:
                break
        common.sync(self.device)
        self.window_s = time.perf_counter() - t0
        if not self.turns:  # the first turn runs on to its end, outside the window
            self._turn(tok, len(out), tr["turn_tokens"], out)
            self.turns.append((fed.cpu(), torch.stack(out, dim=1).cpu()))

    def end_to_end(self) -> dict:
        return {"decode_tokens_per_s": self.steps * self.traffic["sessions"] / self.window_s}

    def release(self):
        del self.params, self.cache, self.decode
        common.free(self.device)

    def requests(self):
        """[(turn, session)] of the check's sample."""
        n = self.traffic["sessions"]
        pick = common.sample(len(self.turns) * n, self.traffic["sample_requests"],
                             stream_seed(self.seed, "sample"))
        return [(i // n, i % n) for i in pick]

    def reference_logits(self, weights, numerics: str):
        """{(turn, session): float32 logits (turn_tokens, V) at the served positions}."""
        h = self.traffic["history"]
        out = {}
        for t, s in self.requests():
            fed, served = self.turns[t]
            seq = torch.cat([self.history[s].to(self.device), fed[s:s + 1].to(self.device),
                             served[s, :-1].to(self.device, torch.int32)])[None]
            out[(t, s)] = llama.logits_rows(self.cfg, weights, seq, h, h + served.shape[1],
                                            llama.Numerics(numerics))[0]
        return out

    def served(self, key):
        """The served tokens of request (turn, session)."""
        t, s = key
        return self.turns[t][1][s]

    def check(self) -> dict:
        weights = draw_weights(self.cfg, self.seed, self.device)
        self.ref = self.reference_logits(weights, "f32")
        del weights
        gaps = [common.served_gaps(logits, self.served(key)) for key, logits in self.ref.items()]
        return {"served_token_gap": float(torch.cat(gaps).max())}
