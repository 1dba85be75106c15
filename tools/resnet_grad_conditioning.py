"""How far the ResNet baseline's training gradient moves under tiny perturbations.

Builds the ResNet of ``PACKAGED["classification/acdc"]`` with ``model.name=resnet`` (basic blocks
[3, 4, 6, 3], 64-512 channels, 3-D, ED and ES as two channels) with the seeded initialisation, takes
one seeded batch of min-max scaled noise with a bright box, and prints one JSON line with, per
parameter, the largest difference of its train-mode gradient (classification loss, BatchNorm over batch
statistics) relative to its largest entry:

- ``f32_vs_f64``: the gradient computed in float32 against float64, on the same device;
- ``f64_weights_1e-7``: float64 after every weight is scaled by (1 + 1e-7 * N(0, 1)), against float64.

Usage:
    python tools/resnet_grad_conditioning.py [--device cpu] [--batch 2] [--size 192 192 16] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cinema_tpu_torch.config import PACKAGED, from_dict  # noqa: E402
from cinema_tpu_torch.factory import init_weights  # noqa: E402
from cinema_tpu_torch.tasks.classification import classification_loss_fn, get_classification_model  # noqa: E402


def gradients(model, batch, dtype):
    model = model.to(dtype)
    for module in model.modules():  # the compute dtype of the convolutions and the head
        if isinstance(getattr(module, "dtype", None), torch.dtype):
            module.dtype = dtype
    images = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    loss = classification_loss_fn(model.train(), images)[0]
    return [g.double() for g in torch.autograd.grad(loss, list(model.parameters()))]


def worst(names, got, want, n=5):
    errs = [(((a - b).abs().max() / b.abs().max().clamp(min=1e-300)).item(), name)
            for name, a, b in zip(names, got, want)]
    return [{"parameter": name, "max_rel_err": e} for e, name in sorted(errs, reverse=True)[:n]]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--size", type=int, nargs=3, default=(192, 192, 16))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    device = torch.device(args.device)
    torch.backends.cudnn.allow_tf32 = False  # float32 convolutions on a card, as on the CPU
    config = from_dict(PACKAGED["classification/acdc"])
    config.model.name = "resnet"
    rng = np.random.default_rng(args.seed)
    image = rng.normal(60, 25, (args.batch, *args.size, 2))
    x, y = args.size[0] // 4, args.size[1] // 4
    image[:, x : 2 * x, y : 2 * y] += 120
    image = (image - image.min()) / (image.max() - image.min())
    batch = {"sax_image": torch.from_numpy(image).to(device),
             "label": torch.from_numpy(rng.integers(0, 5, args.batch)).to(device)}
    state = init_weights(get_classification_model(config, device=device), seed=args.seed).state_dict()

    def fresh():
        model = get_classification_model(config, device=device)
        model.load_state_dict(state)
        return model

    names = [name for name, _ in fresh().named_parameters()]
    g32, g64 = gradients(fresh(), batch, torch.float32), gradients(fresh(), batch, torch.float64)
    moved = fresh().to(torch.float64)
    gen = torch.Generator().manual_seed(args.seed + 1)
    with torch.no_grad():
        for p in moved.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen, dtype=torch.float64).to(device))
    g64_moved = gradients(moved, batch, torch.float64)
    print(json.dumps({"device": str(device), "seed": args.seed, "batch": args.batch, "size": list(args.size),
                      "f32_vs_f64": worst(names, g32, g64), "f64_weights_1e-7": worst(names, g64_moved, g64)}))


if __name__ == "__main__":
    main()
