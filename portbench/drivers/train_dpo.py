"""Closed-loop Diffusion-DPO LoRA training: ``make_dpo_train_step``'s
``train_step`` called back to back, one preference pair (winner and loser
latents, a prompt, a timestep and noise, all from the seed, every pair new)
a call, an update every ``accumulate_grad_batches`` calls. The unit of work
is a pair.

The run resumes a job at update ``resume_update``: the LoRA from the seed
with a non-zero B, first moments 0, second moments ``resume_second_moment``.
Set-up drives the first ``check_steps`` calls, which the check follows with
the plain reference; the window continues from there and ends on an update.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from portbench import flops
from portbench.reference import dit as ref_dit
from portbench.reference import dpo as ref_dpo
from portbench.reference import float32_exact
from portbench.weights import generator, make_dit_weights, make_lora


def leaf_gap(got: List[float], want: List[float]) -> float:
    """The widest gap between the program's and the reference's norm of a
    leaf, over the larger of that leaf's reference norm and the median
    leaf's."""
    med = statistics.median(want)
    worst = 0.0
    for g, w in zip(got, want):
        denom = max(w, med)
        gap = abs(g - w) / denom if denom > 0 else (0.0 if g == w else float("inf"))
        worst = max(worst, gap if gap == gap else float("inf"))
    return worst


class Driver:
    unit_name = "pair"
    time_metric = "train_pair_ms"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.model, self.video, self.train = config["model"], config["video"], config["train"]
        self.check_steps = traffic["check_steps"]
        self.losses: List[float] = []
        self.readings: Dict[str, List[float]] = {}
        self.window_losses: List[torch.Tensor] = []
        self.details: Dict[str, object] = {}

    # --- inputs ----------------------------------------------------------

    def pair(self, i: int) -> Dict[str, torch.Tensor]:
        g = generator(self.device, self.seed, "pair", i)
        m, v = self.model, self.video
        lat = (self.train["batch_size"], m["in_channels"], v["latent_frames"],
               v["latent_height"], v["latent_width"])

        def normal(s):
            return torch.randn(s, generator=g, device=self.device, dtype=torch.float32)

        x_win, x_lose = normal(lat), normal(lat)
        prompt = normal((lat[0], m["max_text_seq_length"], m["text_embed_dim"]))
        t = torch.randint(0, 1000, (lat[0],), generator=g, device=self.device)
        noise = normal((lat[0], lat[2], lat[1], lat[3], lat[4]))
        return {"x_win": x_win, "x_lose": x_lose, "prompt_emb": prompt, "timesteps": t,
                "noise": noise}

    def lora(self):
        return make_lora(self.model, self.train["lora_rank"], self.traffic["lora_b_bound"],
                         self.seed, self.device)

    # --- the program -----------------------------------------------------

    def setup(self) -> None:
        from videogpa_torch.train.lora import lora_leaves
        from videogpa_torch.train.trainer import (
            TrainerConfig, init_train_state, make_dpo_train_step)

        from portbench.program import build_dit, cogvideox_config

        t = self.train
        tcfg = TrainerConfig(
            learning_rate=t["learning_rate"], beta=t["beta"], warmup_steps=t["warmup_steps"],
            max_steps=t["max_steps"], gradient_clip_val=t["gradient_clip_val"],
            weight_decay=t["weight_decay"], accumulate_grad_batches=t["accumulate_grad_batches"],
            lora_rank=t["lora_rank"], lora_alpha=t["lora_alpha"], remat=t["remat"])
        self.dit = build_dit(self.config, make_dit_weights(self.model, self.seed, self.device))
        self.state = init_train_state(self.lora(), tcfg)
        opt = self.state.opt_state
        opt["count"] = self.traffic["resume_update"]
        for nu in opt["nu"]:
            nu.fill_(self.traffic["resume_second_moment"])
        self.train_step, _ = make_dpo_train_step(self.dit, cogvideox_config(self.config), tcfg)
        start = [p.detach().clone() for p in lora_leaves(self.state.lora)]
        for i in range(self.check_steps):
            metrics = self._step(i)
            self.losses.append(float(metrics["loss"]))
            if i == 0:
                self.readings["first_grad"] = [float(g.norm()) for g in self.first_gradient()]
        self.readings["change"] = [float((p.detach() - s).norm())
                                   for p, s in zip(lora_leaves(self.state.lora), start)]
        self.readings["losses"] = self.losses

    def first_gradient(self) -> List[torch.Tensor]:
        """The gradient the optimizer got from the one call so far, from its
        state: the accumulator, or without accumulation the first moment
        over (1 - b1)."""
        opt = self.state.opt_state
        if "acc_grads" in opt:
            return list(opt["acc_grads"])
        return [m / (1.0 - ref_dpo.B1) for m in opt["mu"]]

    def _step(self, i: int):
        p = self.pair(i)
        batch = {k: p[k] for k in ("x_win", "x_lose", "prompt_emb")}
        self.state, metrics = self.train_step(self.state, batch, timesteps=p["timesteps"],
                                              noise=p["noise"])
        return metrics

    def unit(self, n: int) -> int:
        self.window_losses.append(self._step(self.check_steps + n)["loss"])
        return 1

    def can_stop(self, n_units: int) -> bool:
        return (self.check_steps + n_units) % self.train["accumulate_grad_batches"] == 0

    def failed(self) -> int:
        return sum(not bool(torch.isfinite(x)) for x in self.window_losses)

    def release(self) -> None:
        self.dit = self.state = self.train_step = None

    # --- what the window's work is --------------------------------------

    def work(self) -> Dict[str, float]:
        return flops.train_pair(self.model, self.video, self.train["lora_rank"],
                                self.train["remat"])

    def expected_launches(self, units: int) -> Dict[str, int]:
        w = self.work()
        return {"flash_attn_fwd": units * w["attn_fwd_calls"],
                "flash_attn_bwd": units * w["attn_bwd_calls"]}

    # --- the check ------------------------------------------------------

    def reference_readings(self, prec: str) -> Dict[str, List[float]]:
        weights = make_dit_weights(self.model, self.seed, self.device)
        scaling = self.train["lora_alpha"] / self.train["lora_rank"]

        def forward(x, emb, t, lora):
            return ref_dit.dit_forward(weights, self.model, x, emb, t, prec, lora=lora,
                                       scaling=scaling, remat=lora is not None)

        pairs = [self.pair(i) for i in range(self.check_steps)]
        with float32_exact():
            return ref_dpo.train_steps(forward, pairs, self.lora(), self.train,
                                       self.traffic["resume_update"],
                                       self.traffic["resume_second_moment"])

    def reference(self) -> Dict[str, List[float]]:
        return self.reference_readings("f32")

    def check(self, readings: Dict[str, List[float]] = None,
              want: Dict[str, List[float]] = None) -> Dict[str, float]:
        """Each checked step's loss, the first gradient and the change after
        the checked steps, each as the widest gap from the reference. Only
        the loss sees the frozen reference forwards: at the recipe's beta
        their errors move the gradient by a share of ~|logit| / 2, under
        its rounding (PERF.md)."""
        got = readings or self.readings
        want = want or self.reference()
        # leaves whose reference gradient is nought to rounding move by
        # round-off alone: their change is not compared
        floor = 1e-3 * statistics.median(want["first_grad"])
        moved = [i for i, g in enumerate(want["first_grad"]) if g >= floor]
        self.details = {"program": got, "reference": want}
        return {"loss_rel": max(abs(g - w) / abs(w) for g, w in zip(got["losses"],
                                                                   want["losses"])),
                "grad_leaf_gap": leaf_gap(got["first_grad"], want["first_grad"]),
                "change_leaf_gap": leaf_gap([got["change"][i] for i in moved],
                                            [want["change"][i] for i in moved])}

    def control_outputs(self) -> Dict[str, List[float]]:
        """The control: the reference in float8 in the program's place (the
        program's int8 path is inference only and raises under grad)."""
        return self.reference_readings("fp8")
