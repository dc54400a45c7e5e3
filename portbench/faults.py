"""Faults planted under the timed path, each of which the check has to
catch: a step that returns its state unchanged, half of the batch left out
(the mean taken over the rest), an answer altered where it is produced, and
two of the frozen reference forwards: skipped (the policy's own errors
taken as the reference's) and their prediction altered where it is
produced. ``reference_int8`` runs the reference forwards through the port's
int8-QK attention, the shortcut a later change might take; it is read, not
required to fail (PERF.md). The benchmark's tests drive whole runs with
each planted, and ``portbench.control`` reads them on the card; a run of
the benchmark never plants one.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

FAULTS = ("state_unchanged", "half_batch", "answer_altered", "reference_skipped",
          "reference_altered")
READINGS = FAULTS + ("reference_int8",)


@contextlib.contextmanager
def _patched(obj, name: str, value) -> Iterator[None]:
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def planted(fault: str):
    """A context in which the port's DPO step carries ``fault``."""
    import videogpa_torch.train.trainer as trainer

    if fault not in READINGS:
        raise ValueError(f"no fault {fault!r}; have {READINGS}")
    update = trainer.Optimizer.update
    if fault == "state_unchanged":
        return _patched(trainer.Optimizer, "update", lambda self, grads, state, params: None)
    if fault == "half_batch":
        def last_only(self, grads, state, params):
            if self.k > 1 and state["mini_step"] == self.k - 1:
                # the earlier mini-steps' gradients dropped: the running
                # mean becomes this one's alone
                for acc, g in zip(state["acc_grads"], grads):
                    acc.copy_(g)
            return update(self, grads, state, params)
        return _patched(trainer.Optimizer, "update", last_only)
    if fault == "answer_altered":
        reduce_grads = trainer.reduce_grads

        def altered(grads, *a, **k):
            grads = list(reduce_grads(grads, *a, **k))
            grads[5] = grads[5] * 1.25  # to_v.lora_B's gradient, where it is produced
            return grads
        return _patched(trainer, "reduce_grads", altered)
    if fault == "reference_skipped":
        loss = trainer.DPOLoss.__call__

        def skipped(self, v_win, v_lose, v_win_ref, v_lose_ref, *targets):
            # the reference's errors taken to be the policy's own
            return loss(self, v_win, v_lose, v_win.detach(), v_lose.detach(), *targets)
        return _patched(trainer.DPOLoss, "__call__", skipped)
    forward = trainer.dit_forward

    if fault == "reference_altered":
        calls = [0]

        def altered_ref(model, x, *a, lora=None, **k):
            v = forward(model, x, *a, lora=lora, **k)
            if lora is None:
                calls[0] += 1
                if calls[0] % 2 == 1:
                    # the frozen model's prediction of the winner (the first
                    # of a step's two), one latent frame off by 5 %
                    v[:, 0] *= 1.05
            return v
        return _patched(trainer, "dit_forward", altered_ref)

    def int8_ref(model, x, *a, lora=None, **k):
        if lora is None:
            k["attn_impl"] = "flash_int8"
        return forward(model, x, *a, lora=lora, **k)
    return _patched(trainer, "dit_forward", int8_ref)
