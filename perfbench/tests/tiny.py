"""Cells of the benchmark at a size the CPU holds: the configurations' widths cut to the tiny ViT
preset and small images, the pools and mixes shrunk, a data-parallel cell on two gloo ranks of two
rows each; everything else as the workload files say."""

from __future__ import annotations

import copy

import torch

from perfbench.harness import cell as cells
from perfbench.harness import registry


DDP_RANKS = 2


def tiny_config(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    if "convunetr" in cfg["model"]:
        cfg["model"]["convunetr"].update(size="tiny", enc_conv_chans=[4, 8], dec_chans=[4, 8, 16, 32, 64])
        cfg["data"]["sax"]["patch_size"] = [32, 32, 4]
    else:
        cfg["model"].update(size="tiny", enc_conv_chans=[4, 8])
        cfg["data"]["sax"]["patch_size"] = [32, 32, 4]
        cfg["data"]["lax"]["patch_size"] = [32, 32]
    return cfg


def tiny_workload(workload: dict) -> dict:
    workload = copy.deepcopy(workload)
    traffic = workload["traffic"]
    if workload["kind"] == "train_pool":
        traffic["batch"] = 2
        workload["correct"]["ref_block"] = 1
    elif workload["kind"] == "train_ddp":
        traffic["batch"] = DDP_RANKS * 2
        workload["correct"]["ref_block"] = 1
    else:
        traffic.update(n_studies=4, x=[20, 32], y=[20, 32], z=[2, 4], long_t=10, short_t=[5, 7])
        workload["correct"].update(n_frames=3)
    return workload


def tiny_cell(name: str, seed: int = 12345, fault=None, seconds: float = 0.5) -> cells.Cell:
    full = registry.workload(name)
    workload = tiny_workload(full)
    # the tiny batch keeps the configured accumulation: batch_size scales with the micro-batch
    cfg = tiny_config(registry.config(full["config"]))
    if workload["kind"] == "train_pool":
        k = cfg["train"]["batch_size"] // cfg["train"]["batch_size_per_device"]
        cfg["train"]["batch_size_per_device"] = workload["traffic"]["batch"]
        cfg["train"]["batch_size"] = k * workload["traffic"]["batch"]
    elif workload["kind"] == "train_ddp":
        cfg["n_devices"] = DDP_RANKS
        cfg["train"]["batch_size"] = workload["traffic"]["batch"]
        cfg["train"]["batch_size_per_device"] = workload["traffic"]["batch"] // DDP_RANKS
    return cells.Cell(name, workload, cfg, seed, seconds, False, torch.device("cpu"), fault=fault)
