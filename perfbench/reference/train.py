"""The reference's training: the first calls of a train step, followed in plain PyTorch.

A call is one micro-batch: the loss, its gradient, and AdamW with gradient accumulation as the
published recipe sets it (cinema/optim.py: warmup then half-cosine learning rate, the rate taken
at the update count before it is advanced and the bias correction after; clipping of the mean
gradient's global norm; decoupled weight decay on tensors of two or more axes; BEiT layer-wise
rate decay for fine-tuning). Each call's noise comes from a generator seeded with
``seed * 1_000_003 + call``: MAE masks (drawn view after view for the whole batch) and dropout and
drop-path (drawn layer after layer for the whole batch). Rows are run in blocks that fit; each block
sees its rows of the whole batch's noise and adds its share of the mean gradient.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.reference import models as ref
from perfbench.reference.lowp import float32_products


def optimizer_settings(cfg: dict, step: str, n_batches: int, batch: int) -> dict:
    """The update's settings for a run whose epoch is ``n_batches`` micro-batches of ``batch`` rows."""
    t = cfg["train"]
    k = t["batch_size"] // batch
    steps_per_epoch = max(n_batches // k, 1)
    settings = {
        "lr": float(t["lr"]), "min_lr": float(t["min_lr"]), "betas": tuple(t["betas"]),
        "weight_decay": float(t["weight_decay"]), "clip": float(t["clip_grad"]), "accum": k,
        "warmup": float(t["n_warmup_epochs"] * steps_per_epoch), "max_steps": float(t["n_epochs"] * steps_per_epoch),
        "layer_decay": None, "n_blocks": 0,
    }
    if step == "segmentation" and t.get("layer_decay") is not None:
        settings["layer_decay"] = float(t["layer_decay"])
        settings["n_blocks"] = ref.vit_widths(cfg["model"]["convunetr"])["enc_depth"]
    return settings


def layer_id(name: str, n_layers: int) -> int:
    """BEiT's layer of a parameter: 0 for stems and embeddings, i + 1 for encoder block i, the top otherwise."""
    if name.startswith("enc_") or any(x in name for x in ("cls_token", "pos_embed", "patch_embed")):
        return 0
    if name.startswith("encoder.blocks."):
        return int(name.split(".")[2]) + 1
    return n_layers


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], s: dict) -> None:
        self.params, self.s = params, s
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.acc = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0
        self.micro = 0
        self.scale = {n: 1.0 for n in params}
        if s["layer_decay"] is not None:
            n_layers = s["n_blocks"] + 1
            self.scale = {n: s["layer_decay"] ** (n_layers - layer_id(n, n_layers)) for n in params}

    def lr(self, count: int) -> float:
        s = self.s
        if count < s["warmup"]:
            return s["lr"] * count / max(s["warmup"], 1e-8)
        progress = (count - s["warmup"]) / max(s["max_steps"] - s["warmup"], 1e-8)
        return s["min_lr"] + (s["lr"] - s["min_lr"]) * 0.5 * (1.0 + math.cos(math.pi * progress))

    @torch.no_grad()
    def micro_step(self, grads: Dict[str, torch.Tensor]) -> None:
        k = self.s["accum"]
        for n, g in grads.items():
            self.acc[n] += g / k
        self.micro += 1
        if self.micro < k:
            return
        b1, b2 = self.s["betas"]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in self.acc.values()))
        clip = torch.clamp(self.s["clip"] / norm, max=1.0)
        lr = self.lr(self.count)
        self.count += 1
        for n, p in self.params.items():
            g = self.acc[n] * clip
            self.mu[n] = b1 * self.mu[n] + (1 - b1) * g
            self.nu[n] = b2 * self.nu[n] + (1 - b2) * g * g
            update = (self.mu[n] / (1 - b1**self.count)) / (torch.sqrt(self.nu[n] / (1 - b2**self.count)) + 1e-8)
            if p.ndim > 1:
                update = update + self.s["weight_decay"] * p
            p -= lr * self.scale[n] * update
            self.acc[n].zero_()
        self.micro = 0


def call_generator(seed: int, call: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + int(call)) % (2**63))


def loss_and_grad(model: torch.nn.Module, step: str, cfg: dict, batch: Dict[str, torch.Tensor],
                  gen: torch.Generator, block: int) -> torch.Tensor:
    """The call's loss; the mean gradient is left in the parameters' ``.grad``."""
    first = next(iter(batch.values()))
    rows = first.shape[0]
    noise = ref.Noise()
    ref.set_noise(model, noise)
    noise.gen, noise.batch = gen, rows
    masks = None
    if step == "mae":
        ratio = cfg["train"]["enc_mask_ratio"]
        masks = {v: ref.draw_masks(gen, rows, model.enc_down_dict[v].n_patches, ratio, first.device)
                 for v in model.views}
    start = gen.get_state()
    total = torch.zeros((), device=first.device)
    for lo in range(0, rows, block):
        part = slice(lo, min(lo + block, rows))
        gen.set_state(start)
        noise.rows = part
        if step == "mae":
            loss = model({v: batch[v][part].float() for v in model.views},
                         {v: {k: m[part] for k, m in masks[v].items()} for v in model.views})
        else:
            loss = ref.segmentation_loss(model(batch["sax_image"][part].float()), batch["sax_label"][part])
        share = (part.stop - part.start) / rows
        (loss * share).backward()
        total += loss.detach() * share
    return total


def follow(step: str, cfg: dict, weights: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]],
           seed: int, settings: dict, lowp, block: int) -> dict:
    """Run the first ``len(batches)`` calls from ``weights``; returns the losses (``loss``), the first
    call's gradient (``grad_t``, and its norm per leaf ``grad``), and after the last call each leaf's
    change (``change_t``) and accumulated gradient (``acc_t``, the sum of the micro-batches' means)."""
    device = next(iter(weights.values())).device
    with torch.device(device):
        model = ref.MODELS[step](cfg)
    model = model.to(device)
    model.load_state_dict(weights, strict=True)
    ref.set_lowp(model, lowp)
    model.train()
    params = dict(model.named_parameters())
    opt = AdamW({n: p.data for n, p in params.items()}, settings)
    out = {"loss": []}
    with float32_products():
        for i, batch in enumerate(batches):
            loss = loss_and_grad(model, step, cfg, batch, call_generator(seed, i, device), block)
            grads = {n: p.grad for n, p in params.items()}
            if i == 0:
                out["grad_t"] = {n: g.detach().clone() for n, g in grads.items()}
                out["grad"] = {n: float(g.norm()) for n, g in grads.items()}
            opt.micro_step(grads)
            for p in params.values():
                p.grad = None
            out["loss"].append(float(loss))
    with torch.no_grad():
        out["change_t"] = {n: p.detach() - weights[n] for n, p in params.items()}
        out["acc_t"] = {n: a * settings["accum"] for n, a in opt.acc.items()}
    return out
