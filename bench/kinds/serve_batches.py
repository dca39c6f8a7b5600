"""Traffic kind ``serve_batches``: a closed loop of batches of requests that
share one prompt length; each batch is prefilled, its cache grown, and a few
tokens decoded greedily, in the order of the port's serving driver
(``make_prefill_step``, ``launch.serve._grow_cache``, ``make_decode_step``).

The lengths come in cycles, each cycle the file's multiset of prompt lengths
in an order drawn from the seed, so every seed asks for the same work.  A
request's time to first token runs from its batch's issue to the first token
on the host.

The check: once the window has closed, a sample of the finished requests
drawn from the seed (one of the longest always among them) is run through
the float32 reference, prompt and served tokens together; the number is the
widest gap by which a served token's reference logit lies below the
reference's best at its position.
"""
from __future__ import annotations

import time

import numpy as np
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

        self.pcfg = program_config(self.cfg)
        mvcfg = common.movement_config(self.traffic["movement"])
        self.params = to_tree(draw_weights(self.cfg, self.seed, self.device,
                                           then=lambda x: mv.working_copy(x, mvcfg)))
        self.prefill = steps.make_prefill_step(self.pcfg)
        self.decode = steps.make_decode_step(self.pcfg)
        warm = generator(self.seed, "warm-up", self.device)
        for length in sorted(set(self.traffic["prompt_lens"])):
            self._serve(self._prompts(warm, length))

    def _prompts(self, gen, length):
        return token_ids(gen, self.cfg["vocab_size"], (self.traffic["batch"], length), self.device)

    def lengths(self):
        rng = np.random.default_rng(stream_seed(self.seed, "order"))
        lens = list(self.traffic["prompt_lens"])
        while True:
            yield from (lens[i] for i in rng.permutation(len(lens)))

    def _serve(self, tokens):
        """(time to first token, served tokens (B, gen) on the host)."""
        from repro_torch.launch.serve import _grow_cache

        length, gen = tokens.shape[1], self.traffic["gen_tokens"]
        t0 = time.perf_counter()
        with record_function("bench.prefill"):
            logits, cache = self.prefill(self.params, {"tokens": tokens})
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            tok.cpu()
        ttft = time.perf_counter() - t0
        with record_function("bench.grow_cache"):
            cache = _grow_cache(self.pcfg, cache, length + gen)
        out = [tok]
        for i in range(gen - 1):
            with record_function("bench.decode_step"):
                tok, _, cache = self.decode(self.params, cache, tok, length + i)
            out.append(tok)
        return ttft, torch.stack(out, dim=1).cpu()

    def window(self, seconds: float, tracer):
        self.done = []  # (prompts on the device, served tokens, ttft) a batch
        gen = generator(self.seed, "prompts", self.device)
        order = self.lengths()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or tracer.pending:
            tokens = self._prompts(gen, next(order))
            with tracer.unit(batch=tokens.shape[0], prompt_len=tokens.shape[1]) as info:
                ttft, served = self._serve(tokens)
                info["ttft_s"] = ttft
            self.done.append((tokens, served, ttft))
        self.window_s = time.perf_counter() - t0
        self.attempted = sum(t.shape[0] for t, _, _ in self.done)

    def end_to_end(self) -> dict:
        ttfts = [ttft for t, _, ttft in self.done for _ in range(t.shape[0])]
        return {"ttft_p95_s": common.nearest_rank(ttfts, 0.95)}

    def release(self):
        del self.params, self.prefill, self.decode
        common.free(self.device)

    def requests(self):
        """[(batch index, row)] of the check's sample."""
        b = self.traffic["batch"]
        longest = max(t.shape[1] for t, _, _ in self.done)
        must = [i * b + r for i, (t, _, _) in enumerate(self.done) if t.shape[1] == longest
                for r in range(b)]
        pick = common.sample(len(self.done) * b, self.traffic["sample_requests"],
                             stream_seed(self.seed, "sample"), must)
        return [(i // b, i % b) for i in pick]

    def reference_logits(self, weights, numerics: str):
        """{(batch, row): float32 logits (gen, V) at the served positions}."""
        out = {}
        by_batch = {}
        for i, r in self.requests():
            by_batch.setdefault(i, []).append(r)
        for i, rows in by_batch.items():
            prompts, served, _ = self.done[i]
            length = prompts.shape[1]
            seq = torch.cat([prompts[rows].to(self.device),
                             served[rows, :-1].to(self.device, torch.int32)], dim=1)
            logits = llama.logits_rows(self.cfg, weights, seq, length - 1,
                                       length - 1 + served.shape[1], llama.Numerics(numerics))
            for j, r in enumerate(rows):
                out[(i, r)] = logits[j]
        return out

    def served(self, key):
        """The served tokens of request (batch, row)."""
        i, r = key
        return self.done[i][1][r]

    def check(self) -> dict:
        weights = draw_weights(self.cfg, self.seed, self.device)
        self.ref = self.reference_logits(weights, "f32")
        del weights
        gaps = [common.served_gaps(logits, self.served(key)) for key, logits in self.ref.items()]
        return {"served_token_gap": float(torch.cat(gaps).max())}
