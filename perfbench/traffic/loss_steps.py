"""Closed-loop training steps against the differentiable loss.

At set-up: a batch of ``batch`` seeded reference images (one scene each) on
the device as display-encoded float32 (B, 3, 1, H, W), and the loss function
built once (``cvvdp(display_name=...).get_loss_fn(H, W)``, its defaults).
Step i draws the test batch on the device from a generator seeded by (seed,
i): the references plus seeded noise of a seeded amplitude, clipped to
[0, 1], a leaf that requires its gradient; then ``loss_fn(test,
ref).backward()`` and a synchronisation. A traced step also synchronises
before the backward and times it.

The comparison: steps drawn from the seed among the first ones every window
reaches (``min_steps_per_s`` a second) keep their loss and a copy of their
gradient; after the window the float32 reference recomputes both from the
same inputs. ``loss_gap`` is the largest loss gap, ``grad_rel_gap`` the
largest gradient gap relative to the reference gradient's largest entry.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import content
from perfbench.reference.cvvdp_ref import CVVDPReference

SEED_CHECK = 4
NOISE_RANGE = (0.01, 0.05)


class Traffic:
    def __init__(self, cell, seed, device, program=None):
        self.cell, self.seed, self.dev, self.program_name = cell, int(seed), device, program
        self.W, self.H = cell.config["resolution"]
        self.display = cell.config["display"]
        self.B = int(cell.mix["batch"])

    def setup(self):
        g = content.generator(self.seed, 0, self.dev)
        self.ref = torch.stack([content.Scene(g, self.H, self.W, self.dev).frames(0, 1)[0]
                                for _ in range(self.B)])[:, :, None].contiguous()
        if self.program_name in (None, "port"):
            import colorvideovdp_tpu_torch as cvt

            self.fn = cvt.cvvdp(display_name=self.display, device=self.dev).get_loss_fn(
                self.H, self.W)
        elif self.program_name == "control":
            self.fn = CVVDPReference(self.display, self.dev, torch.bfloat16).loss
        else:
            raise ValueError(f"unknown program {self.program_name!r}")
        mix = self.cell.mix
        reach = max(int(mix["check_steps"]), int(mix["min_steps_per_s"] * mix["window_floor_s"]))
        picks = content.host_rng(self.seed, SEED_CHECK).choice(
            reach, size=int(mix["check_steps"]), replace=False)
        self.slots = {int(i): k for k, i in enumerate(sorted(picks))}
        pin = self.dev.type == "cuda"
        self.grads = torch.empty((len(self.slots),) + tuple(self.ref.shape), pin_memory=pin)
        for i in range(int(mix.get("warmup_steps", 1))):
            self._step(i, stream=1)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def test_batch(self, i, stream=0):
        g = content.generator(self.seed, 1_000_000 * (stream + 1) + i, self.dev)
        amp = NOISE_RANGE[0] + (NOISE_RANGE[1] - NOISE_RANGE[0]) * float(
            np.random.default_rng([self.seed, 100 + stream, i]).random())
        with torch.no_grad():
            t = (self.ref + amp * torch.randn(self.ref.shape, generator=g, device=self.dev))
            return t.clamp_(0.0, 1.0).requires_grad_(True)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _step(self, i, stream=0, trace=False):
        test = self.test_batch(i, stream)
        with record_function("perfbench.forward"):
            loss = self.fn(test, self.ref)
        if trace:
            self._sync()
            t0 = time.perf_counter()
        with record_function("perfbench.backward"):
            loss.backward()
        self._sync()
        rec = {"i": i, "loss": loss.detach()}
        if trace:
            rec["backward_s"] = time.perf_counter() - t0
        return rec, test

    def request(self, i, trace=False):
        rec, test = self._step(i, trace=trace)
        if i in self.slots:
            grad = test.grad if test.grad is not None else torch.zeros_like(test)
            self.grads[self.slots[i]].copy_(grad, non_blocking=True)
            rec["slot"] = self.slots[i]
        return rec

    def end_to_end(self, records, window, peak):
        return {"step_ms": window / len(records) * 1e3, "train_peak_gib": peak / 2 ** 30}

    def release(self):
        self.fn = None
        self._sync()

    def check(self, records):
        done = {r["i"]: r for r in records if "slot" in r}
        ref = CVVDPReference(self.display, device=self.dev)
        loss_gap = grad_gap = 0.0
        for i, slot in self.slots.items():
            if i not in done:
                loss_gap = grad_gap = math.inf  # an answer that never came
                continue
            L, g = ref.loss_grad(self.test_batch(i).detach(), self.ref)
            gap = abs(float(done[i]["loss"]) - L)
            ggap = float((self.grads[slot].to(g.device) - g).abs().max() / g.abs().max())
            loss_gap = max(loss_gap, gap if math.isfinite(gap) else math.inf)
            grad_gap = max(grad_gap, ggap if math.isfinite(ggap) else math.inf)
        lim = self.cell.mix["limits"]
        return {"loss_gap": {"value": loss_gap, "limit": lim["loss_gap"]},
                "grad_rel_gap": {"value": grad_gap, "limit": lim["grad_rel_gap"]}}
