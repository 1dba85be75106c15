"""Tests of the port that need the card: the CUDA kernels have no CPU or interpret mode.

Run them on a machine with a CUDA device and nvcc:
``python -m pytest tests/test_torch_port_gpu.py -m gpu``. This file imports the port
and torch only. ``chip_smoke.py`` holds the same kernels against their plain versions
at the main paths' shapes.
"""

import numpy as np
import pytest
import torch

from cinema_tpu_torch import trace
from cinema_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_per_head_kernels_agree_with_their_plain_versions(card, dtype, atol):
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 130, 2, 64)).astype(np.float32)).to(card, dtype).requires_grad_()
    k = torch.from_numpy(rng.normal(size=(2, 77, 2, 64)).astype(np.float32)).to(card, dtype).requires_grad_()
    kv = torch.from_numpy(rng.normal(size=(2, 77, 256)).astype(np.float32)).to(card, dtype).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(2, 130, 2, 64)).astype(np.float32)).to(card, dtype)
    v = fa.split_kv(kv, 2)[1]
    heads = ("attention.heads.launches", "attention.heads.bwd_launches")
    before = tuple(map(trace.counter, heads))
    out = fa.flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, kv), g)
    assert tuple(map(trace.counter, heads)) == (before[0] + 1, before[1] + 1)
    want_out = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol, rtol=0)
    want = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), want_out.detach(), g)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol, rtol=0)
    torch.testing.assert_close(got[1].float(), want[1].float(), atol=atol, rtol=0)
    torch.testing.assert_close(got[2].view(2, 77, 2, 2, 64)[:, :, 1].float(), want[2].float(), atol=atol, rtol=0)


@pytest.mark.gpu
def test_a_cuda_tensor_the_kernel_does_not_take_raises(card):
    q = torch.zeros(1, 8, 2, 48, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_packed_backward_at_a_ragged_shape_agrees_with_its_plain_version(card, dtype, atol):
    """dq, dk, dv of the packed kernels at n_q = 129, n_k = 200 (ragged last tiles of both passes),
    head_dim 32, with k and v the column halves of a fused kv projection."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(2, 129, 512)).astype(np.float32)).to(card, dtype).requires_grad_()
    kv = torch.from_numpy(rng.normal(size=(2, 200, 1024)).astype(np.float32)).to(card, dtype).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(2, 129, 512)).astype(np.float32)).to(card, dtype)
    before = trace.counter("attention.packed.bwd_launches")
    out = fa.flash_attention_packed_kv(q, kv, 16)
    dq, dkv = torch.autograd.grad(out, (q, kv), g)
    assert trace.counter("attention.packed.bwd_launches") == before + 1
    want = fa.flash_attention_packed_bwd_plain(q.detach(), kv[..., :512].detach(), kv[..., 512:].detach(),
                                               out.detach(), g, 16)
    torch.testing.assert_close(dq.float(), want[0].float(), atol=atol, rtol=0)
    torch.testing.assert_close(dkv[..., :512].float(), want[1].float(), atol=atol, rtol=0)
    torch.testing.assert_close(dkv[..., 512:].float(), want[2].float(), atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layout", ["packed", "bhtd"])
def test_forward_at_a_ragged_cross_shape_agrees_with_its_plain_version(card, dtype, atol, layout):
    """The forward of both layouts at ragged cross shapes: packed n_q = 129, n_k = 200, head_dim 32, with
    k and v the column halves of a fused kv projection; per-head n_q = 130, n_k = 77, head_dim 64, every
    operand read through a (batch, heads, tokens, head_dim) transpose. The output is the same with and
    without the saved log-sum-exp, and the log-sum-exp is held to its plain version (atol 1e-3)."""
    rng = np.random.default_rng(7)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(card, dtype)

    if layout == "packed":
        q, kv = tensor(2, 129, 512), tensor(2, 200, 1024)
        k, v = kv[..., :512], kv[..., 512:]
        counter = "attention.packed.launches"
        before = trace.counter(counter)
        out = fa.flash_attention_packed(q, k, v, 16)
        out_lse, lse = fa.flash_attention_packed_forward(q, k, v, 16, save_lse=True)
        want, want_lse = fa.flash_attention_packed_plain(q, k, v, 16), fa.flash_attention_packed_lse_plain(q, k, 16)
    else:
        q, k, v = (tensor(2, 12, n, 64).transpose(1, 2) for n in (130, 77, 77))
        counter = "attention.heads.launches"
        before = trace.counter(counter)
        out = fa.flash_attention(q, k, v)
        out_lse, lse = fa.flash_attention_forward(q, k, v, save_lse=True)
        want, want_lse = fa.flash_attention_plain(q, k, v), fa.flash_attention_lse_plain(q, k)
    assert trace.counter(counter) == before + 2
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=0)
    assert torch.equal(out, out_lse)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_q,n_k,heads,d,layout", [
    (1, 1, 12, 64, "kvhalf"), (127, 127, 12, 64, "kvhalf"), (129, 2305, 12, 64, "kvhalf"),
    (2305, 65, 16, 32, "kvhalf"), (130, 77, 12, 64, "bhtd"), (257, 129, 16, 32, "bhtd"), (33, 200, 12, 64, "packed"),
])
def test_f32_forward_ragged_strided_and_transposed_agrees_with_its_plain_version(card, n_q, n_k, heads, d, layout):
    """The split-TF32 forward with sharp scores (q scaled by 4) at ragged q tails (1, 127, 129, 257, 33 and 2305
    rows) and key tails (65, 77, 129, 200 keys, and one), head_dim 64 and 32: v the strided v half of a fused kv
    projection (kvhalf), every operand a (batch, heads, tokens, head_dim) transpose (bhtd), or packed q with k
    and v the column halves of a fused kv projection (packed). Output within chip_smoke's f32 gate (1e-4) of the
    plain version, the log-sum-exp within 1e-3."""
    rng = np.random.default_rng(n_q + n_k + d)

    def tensor(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(card)

    if layout == "packed":
        q, kv = tensor(2, n_q, heads * d) * 4, tensor(2, n_k, 2 * heads * d)
        k, v = kv[..., :heads * d], kv[..., heads * d:]
        out, lse = fa.flash_attention_packed_forward(q, k, v, heads, save_lse=True)
        want = fa.flash_attention_packed_plain(q, k, v, heads)
        want_lse = fa.flash_attention_packed_lse_plain(q, k, heads)
    else:
        if layout == "kvhalf":
            q, k = tensor(2, n_q, heads, d) * 4, tensor(2, n_k, heads, d)
            v = tensor(2, n_k, 2, heads, d)[:, :, 1]
        else:
            q, k, v = (tensor(2, heads, n, d) for n in (n_q, n_k, n_k))
            q, k, v = (q * 4).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        out, lse = fa.flash_attention_forward(q, k, v, save_lse=True)
        want, want_lse = fa.flash_attention_plain(q, k, v), fa.flash_attention_lse_plain(q, k)
    torch.testing.assert_close(out, want.float(), atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n_tokens", [289, 577], ids=["emidec-289", "myops-577"])
def test_packed_kernels_at_the_emidec_and_myops_token_counts_agree_with_their_plain_versions(card, dtype, atol,
                                                                                            n_tokens):
    """The packed forward and backward at batch 4, embed 768, 12 heads and the token counts of an EMIDEC
    (96x96x8: 288 + 1) and a MyoPS2020 (192x192x4: 576 + 1) patch, whose last q tiles hold 33 and 65 rows;
    k and v the column halves of a fused kv projection."""
    rng = np.random.default_rng(n_tokens)
    q = torch.from_numpy(rng.normal(size=(4, n_tokens, 768)).astype(np.float32)).to(card, dtype).requires_grad_()
    kv = torch.from_numpy(rng.normal(size=(4, n_tokens, 1536)).astype(np.float32)).to(card, dtype).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(4, n_tokens, 768)).astype(np.float32)).to(card, dtype)
    packed = ("attention.packed.launches", "attention.packed.bwd_launches")
    before = tuple(map(trace.counter, packed))
    out = fa.flash_attention_packed_kv(q, kv, 12)
    dq, dkv = torch.autograd.grad(out, (q, kv), g)
    assert tuple(map(trace.counter, packed)) == (before[0] + 1, before[1] + 1)
    k, v = kv[..., :768].detach(), kv[..., 768:].detach()
    want_out = fa.flash_attention_packed_plain(q.detach(), k, v, 12)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol, rtol=0)
    want = fa.flash_attention_packed_bwd_plain(q.detach(), k, v, out.detach(), g, 12)
    torch.testing.assert_close(dq.float(), want[0].float(), atol=atol, rtol=0)
    torch.testing.assert_close(dkv[..., :768].float(), want[1].float(), atol=atol, rtol=0)
    torch.testing.assert_close(dkv[..., 768:].float(), want[2].float(), atol=atol, rtol=0)


def _step_on_the_cpu_and_the_card(card, build, loss_fn, batch, zero_grad: str = ""):
    """One f32 step of ``loss_fn`` with block recomputation, from ``init_weights(build(), seed=2)``, on the
    CPU (plain attention) and on the card (the packed kernels), held as chip_smoke.py holds its f32 steps:
    the loss and the gradient norm of the step within rtol 1e-4, and each parameter's gradient within 1e-3
    of its largest entry on the CPU. ``zero_grad`` names a parameter whose gradient is zero analytically
    and rounding noise on either device (the weight of the LayerNorm over a one-channel input, whose
    output is its bias); it is held to its bias's largest entry instead. Returns the card's step's
    (forward, backward) launches of the packed kernels."""
    from cinema_tpu_torch.factory import init_weights
    from cinema_tpu_torch.train.optim import build_optimizer
    from cinema_tpu_torch.train.state import TrainState, make_supervised_train_step

    results, grads, launches = [], [], []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # f32 convolutions on the card, as on the CPU
    try:
        for device in ("cpu", card):
            device_batch = {k: v.to(device) for k, v in batch.items()}
            fresh = init_weights(build(), seed=2).to(device).train()
            grads.append([g.cpu() for g in torch.autograd.grad(loss_fn(fresh, device_batch)[0],
                                                                list(fresh.parameters()))])
            model = init_weights(build(), seed=2).to(device)
            trace.reset("attention.packed.launches", "attention.packed.bwd_launches")
            tx = build_optimizer(dict(model.named_parameters()), lr=1e-3)
            step_fn = make_supervised_train_step(model, tx, loss_fn)
            _, metrics = step_fn(TrainState.create(model, tx), device_batch)
            results.append((float(metrics["loss"]), float(metrics["grad_norm"])))
            launches.append((trace.counter("attention.packed.launches"),
                             trace.counter("attention.packed.bwd_launches")))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert launches[0] == (0, 0)
    np.testing.assert_allclose(results[1], results[0], rtol=1e-4)
    want = dict(zip([name for name, _ in build().named_parameters()], grads[0]))
    for (name, expected), got in zip(want.items(), grads[1]):
        scale = want[name.replace("weight", "bias") if name == zero_grad else name]
        assert (got - expected).abs().max() <= 1e-3 * scale.abs().max().clamp(min=1e-12), name
    return launches[1]


def _convunetr(view: str, size: tuple, out_chans: int):
    """A small ConvUNetR (head_dim 32, two blocks, block recomputation) on one view of ``size``."""
    from cinema_tpu_torch.models.convunetr import ConvUNetR

    nd = len(size)
    return ConvUNetR(image_size_dict={view: size}, in_chans_dict={view: 1}, out_chans=out_chans,
                     enc_patch_size_dict={view: (4, 4, 1)[:nd]}, enc_scale_factor_dict={view: (2, 2, 1)[:nd]},
                     enc_conv_chans=(8, 16), enc_conv_n_blocks=1, enc_embed_dim=64, enc_depth=2, enc_n_heads=2,
                     dec_chans=(4, 8, 16, 24, 32), dec_patch_size_dict={view: (2, 2, 1)[:nd]},
                     dec_scale_factor_dict={view: (2, 2, 1)[:nd]}, remat=True)


@pytest.mark.gpu
def test_segmentation_train_step_through_the_kernels_agrees_with_the_cpu_step(card):
    """One f32 step of a small ConvUNetR with ``segmentation_loss_fn`` and block recomputation: two packed
    forward launches and one backward launch per block on the card, the loss, gradient norm and every
    parameter's gradient as the CPU's (``_step_on_the_cpu_and_the_card``)."""
    from cinema_tpu_torch.tasks.segmentation import segmentation_loss_fn

    size = (64, 64, 4)
    rng = np.random.default_rng(8)
    batch = {"sax_image": torch.from_numpy(rng.random((2, *size, 1)).astype(np.float32)),
             "sax_label": torch.from_numpy(rng.integers(-1, 4, size=(2, *size)).astype(np.int8))}
    launches = _step_on_the_cpu_and_the_card(card, lambda: _convunetr("sax", size, 4), segmentation_loss_fn, batch,
                                             zero_grad="dec_image_conv_block_dict.sax.norm1.weight")
    assert launches == (4, 2)


@pytest.mark.gpu
def test_landmark_heatmap_train_step_through_the_kernels_agrees_with_the_cpu_step(card):
    """As the segmentation step, for a small 2-D ConvUNetR on ``lax_2c`` at 64x64 (65 tokens, a ragged
    tile) with ``landmark_loss_fn`` on Gaussian heatmaps and images of 0-255 intensities."""
    from cinema_tpu_torch.data import gaussian_heatmap
    from cinema_tpu_torch.tasks.segmentation.landmark import landmark_loss_fn

    rng = np.random.default_rng(9)
    heatmaps = np.stack([gaussian_heatmap((64, 64), rng.integers(4, 60, size=(3, 2))) for _ in range(2)])
    batch = {"lax_2c_image": torch.from_numpy((rng.random((2, 64, 64, 1)) * 255).astype(np.float32)),
             "lax_2c_label": torch.from_numpy(heatmaps)}
    launches = _step_on_the_cpu_and_the_card(card, lambda: _convunetr("lax_2c", (64, 64), 3), landmark_loss_fn,
                                             batch, zero_grad="dec_image_conv_block_dict.lax_2c.norm1.weight")
    assert launches == (4, 2)


@pytest.mark.gpu
def test_landmark_coordinate_train_step_through_the_kernels_agrees_with_the_cpu_step(card):
    """As the segmentation step, for a small 2-D ConvViT on ``lax_2c`` at 64x64 with six outputs and
    ``landmark_regression_loss_fn`` (Wing losses in pixels)."""
    from cinema_tpu_torch.models.convvit import ConvViT
    from cinema_tpu_torch.tasks.regression.landmark import landmark_regression_loss_fn

    def build():
        return ConvViT(image_size_dict={"lax_2c": (64, 64)}, in_chans_dict={"lax_2c": 1}, n_frames=1, out_chans=6,
                       enc_patch_size_dict={"lax_2c": (4, 4)}, enc_scale_factor_dict={"lax_2c": (2, 2)},
                       enc_conv_chans=(8, 16), enc_conv_n_blocks=1, enc_embed_dim=64, enc_depth=2, enc_n_heads=2,
                       remat=True)

    rng = np.random.default_rng(10)
    batch = {"lax_2c_image": torch.from_numpy((rng.random((2, 64, 64, 1)) * 255).astype(np.float32)),
             "label": torch.from_numpy(rng.random((2, 6)).astype(np.float32)),
             "lax_2c_width": torch.full((2,), 64), "lax_2c_height": torch.full((2,), 64)}
    launches = _step_on_the_cpu_and_the_card(card, build, landmark_regression_loss_fn, batch)
    assert launches == (4, 2)


def _write_mnms_tree(root, name, n, size, seed):
    """``n`` seeded training studies in the processed layout of ``name`` (uint8 SAX images, a bright box
    on noise, and its uint8 label) with ``train_metadata.csv`` (``pid``, ``n_slices``, ``pathology``)."""
    import csv

    from cinema_tpu_torch.config import PACKAGED
    from cinema_tpu_torch.data import save_nifti

    rng = np.random.default_rng(seed)
    classes = PACKAGED[f"classification/{name}"]["data"]["pathology"]
    rows = []
    for i in range(n):
        pid = str(i + 1)
        (root / "train" / pid).mkdir(parents=True)
        for frame in ("ed", "es"):
            label = np.zeros(size, np.uint8)
            x, y = (int(v) for v in rng.integers(8, 20, size=2))
            label[x : x + 20, y : y + 16] = 2
            label[x + 4 : x + 14, y + 4 : y + 12] = 1
            label[x + 20 : x + 28, y : y + 12] = 3
            image = np.clip(label * 60 + rng.normal(40, 15, size), 0, 255).astype(np.uint8)
            save_nifti(root / "train" / pid / f"{pid}_sax_{frame}.nii.gz", image)
            save_nifti(root / "train" / pid / f"{pid}_sax_{frame}_gt.nii.gz", label)
        rows.append({"pid": pid, "n_slices": size[2], "pathology": classes[i % len(classes)]})
    for split in ("train", "val"):
        with open(root / f"{split}_metadata.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)


def _augmented_batch(task, root, patch, keys):
    """The first batch of 2 of ``task``'s training loader (its packaged transforms at ``prob`` 1, the
    patch size ``patch``) on the studies under ``root``, the entries ``keys`` as tensors."""
    import importlib

    from cinema_tpu_torch.config import PACKAGED, from_dict
    from cinema_tpu_torch.data import BatchLoader

    config = from_dict(PACKAGED[task])
    config.data.dir, config.data.sax.patch_size, config.transform.prob = str(root), list(patch), 1.0
    family, name = task.split("/")
    train, _ = importlib.import_module(f"cinema_tpu_torch.tasks.{family}.{name}").load_dataset(config)
    with BatchLoader(train, 2, n_workers=2, processes=True) as loader:
        batch = next(iter(loader.epoch(0)))
    return {k: torch.from_numpy(batch[k]) for k in keys}


@pytest.mark.gpu
def test_mnms_segmentation_step_on_augmented_nifti_batches_agrees_with_the_cpu_step(card, tmp_path):
    """One f32 step of a small ConvUNetR on the first augmented batch of ``segmentation/mnms`` (NIfTI
    studies, loaded by worker processes): the packed kernels on the card, every parameter's gradient as
    the CPU's (``_step_on_the_cpu_and_the_card``)."""
    from cinema_tpu_torch.tasks.segmentation import segmentation_loss_fn

    _write_mnms_tree(tmp_path, "mnms", 4, (72, 70, 5), seed=11)
    batch = _augmented_batch("segmentation/mnms", tmp_path, (64, 64, 4), ("sax_image", "sax_label"))
    assert batch["sax_image"].shape == (2, 64, 64, 4, 1) and batch["sax_label"].dtype == torch.int8
    launches = _step_on_the_cpu_and_the_card(card, lambda: _convunetr("sax", (64, 64, 4), 4), segmentation_loss_fn,
                                             batch, zero_grad="dec_image_conv_block_dict.sax.norm1.weight")
    assert launches == (4, 2)


@pytest.mark.gpu
def test_mnms2_classification_step_on_augmented_nifti_batches_agrees_with_the_cpu_step(card, tmp_path):
    """As the segmentation step, for a small ConvViT on ED + ES of ``classification/mnms2`` (six classes)."""
    from cinema_tpu_torch.models.convvit import ConvViT
    from cinema_tpu_torch.tasks.classification import classification_loss_fn

    def build():
        return ConvViT(image_size_dict={"sax": (32, 32, 4)}, in_chans_dict={"sax": 1}, n_frames=2, out_chans=6,
                       enc_patch_size_dict={"sax": (4, 4, 1)}, enc_scale_factor_dict={"sax": (2, 2, 1)},
                       enc_conv_chans=(8, 16), enc_conv_n_blocks=1, enc_embed_dim=64, enc_depth=2, enc_n_heads=2,
                       remat=True)

    _write_mnms_tree(tmp_path, "mnms2", 6, (40, 36, 5), seed=12)
    batch = _augmented_batch("classification/mnms2", tmp_path, (32, 32, 4), ("sax_image", "label"))
    assert batch["sax_image"].shape == (2, 32, 32, 4, 2)
    assert _step_on_the_cpu_and_the_card(card, build, classification_loss_fn, batch) == (4, 2)


@pytest.mark.gpu
def test_device_prefetch_hands_out_the_loaders_batches_while_the_card_is_busy(card):
    """Ten batches, the arrays' shape changing once, each handed out while the consumer's stream is kept
    busy by a long kernel: every tensor on the card equals its batch bit for bit, although the three
    pinned slots are refilled while earlier copies and steps are queued, and the strings are dropped."""
    from cinema_tpu_torch.data import device_prefetch

    rng = np.random.default_rng(13)
    batches = [{"pid": [f"p{i}"], "sax": rng.random((4, 64, 64, 16, 1), np.float32) if i < 6 else
                rng.random((2, 64, 64, 16, 1), np.float32), "label": np.arange(i, i + 4)} for i in range(10)]
    got = []
    for out in device_prefetch(iter(batches), card, depth=2):
        assert set(out) == {"sax", "label"} and out["sax"].is_cuda
        torch.cuda._sleep(2_000_000)  # a step of a few ms on the consumer's stream
        got.append({k: (v * 1).cpu() for k, v in out.items()})  # read on the consumer's stream
    torch.cuda.synchronize()
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert torch.equal(g["sax"], torch.from_numpy(b["sax"])) and torch.equal(g["label"], torch.from_numpy(b["label"]))


@pytest.mark.gpu
def test_a_nan_batch_leaves_the_resnet_running_statistics_on_the_card(card):
    """A small 3-D ResNet on the card: an f32 step agrees with the CPU's (loss, gradient norm, running
    statistics), and a NaN batch then leaves parameters, moments and running statistics bit-identical."""
    from cinema_tpu_torch.factory import init_weights
    from cinema_tpu_torch.models.resnet import ResNet
    from cinema_tpu_torch.tasks.classification import classification_loss_fn
    from cinema_tpu_torch.train.optim import build_optimizer
    from cinema_tpu_torch.train.state import TrainState, make_supervised_train_step

    rng = np.random.default_rng(14)
    batch = {"sax_image": torch.from_numpy(rng.random((4, 32, 32, 8, 2), np.float32)),
             "label": torch.from_numpy(rng.integers(0, 5, size=4))}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for device in (torch.device("cpu"), card):
            model = init_weights(ResNet(3, 2, 5, layers=(1, 1), layer_inplanes=(8, 16)), seed=3).to(device)
            tx = build_optimizer(dict(model.named_parameters()), lr=1e-3, warmup_steps=0)
            step_fn = make_supervised_train_step(model, tx, classification_loss_fn)
            state, metrics = step_fn(TrainState.create(model, tx), {k: v.to(device) for k, v in batch.items()})
            runs.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                         {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(runs[1][:2], runs[0][:2], rtol=1e-4)
    for key, want in runs[0][2].items():
        torch.testing.assert_close(runs[1][2][key], want, rtol=1e-5, atol=1e-6, msg=key)
    snapshot = [t.clone() for t in (*model.state_dict().values(), *state.opt_state.mu, *state.opt_state.nu)]
    bad = {"sax_image": torch.full_like(batch["sax_image"], float("nan")).to(card), "label": batch["label"].to(card)}
    state, metrics = step_fn(state, bad)
    assert float(metrics["skipped_nan"]) == 1.0
    assert all(torch.equal(a, b) for a, b in zip(snapshot, (*model.state_dict().values(), *state.opt_state.mu,
                                                            *state.opt_state.nu)))


DEPTHWISE_COUNTERS = ("depthwise.launches", "depthwise.dgrad_launches", "depthwise.wgrad_launches")


def _depthwise_inputs(shape, dtype, device, seed, layout="channels_last"):
    rng = np.random.default_rng(seed)
    nd = len(shape) - 2

    def tensor(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))

    x, g = tensor(*shape).to(device, dtype), tensor(*shape).to(device, dtype)
    if layout == "densified":  # (batch, z, x, y, chans) in memory, as the sparse MAE stem hands it over
        x = x.permute(0, 4, 2, 3, 1).contiguous().permute(0, 4, 2, 3, 1)
    else:
        x = x.contiguous(memory_format=torch.channels_last_3d if nd == 3 else torch.channels_last)
    w = (tensor(shape[1], 1, *(5,) * nd) * 0.2).to(device)
    b = tensor(shape[1]).to(device)
    return x, g, w, b


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-8)])
@pytest.mark.parametrize("shape,layout", [
    ((2, 40, 9, 7, 18), "channels_last"), ((2, 64, 12, 8, 16), "densified"), ((3, 5, 7, 5, 1), "channels_last"),
    ((2, 40, 19, 21), "channels_last"), ((2, 128, 32, 32), "channels_last"), ((1, 1, 6, 5), "channels_last"),
])
def test_depthwise_kernels_agree_with_their_plain_versions(card, dtype, rel, shape, layout):
    """Forward, data gradient and weight gradient (with the bias gradient) of the depthwise op through autograd
    on the card against the plain versions in f32 from the same inputs, 2-D and 3-D, at ragged tiles, channel
    counts that are not a multiple of 32, one channel, z = 1, and the sparse stem's strided layout. Each
    direction counts one kernel call; the gradients of weight and bias are f32."""
    from cinema_tpu_torch.ops import depthwise_conv as dc

    x, g, w, b = _depthwise_inputs(shape, dtype, card, seed=sum(shape))
    x.requires_grad_()
    w.requires_grad_()
    b.requires_grad_()
    before = tuple(map(trace.counter, DEPTHWISE_COUNTERS))
    out = dc.depthwise_conv(x, w, b)
    dx, dw, db = torch.autograd.grad(out, (x, w, b), g)
    assert tuple(map(trace.counter, DEPTHWISE_COUNTERS)) == tuple(n + 1 for n in before)
    assert out.dtype == dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    wd = w.detach().to(dtype).float()
    xf = x.detach().float()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = dc.depthwise_conv_plain(xf, wd, b.detach().to(dtype).float())
        want_dx = dc.depthwise_conv_dgrad_plain(g.float(), wd)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want_dw, want_db = dc.depthwise_conv_wgrad_plain(xf, g.float())
    for got, ref, tol in ((out, want, rel), (dx, want_dx, rel), (dw, want_dw, 1e-5), (db, want_db, 1e-5)):
        assert (got.float() - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 64, 48, 48, 16), (16, 128, 32, 32)])
def test_depthwise_weight_gradient_is_bit_identical_over_two_calls(card, shape):
    """No atomics: the weight and bias gradients of two calls on the same inputs are equal bit for bit."""
    from cinema_tpu_torch.ops import depthwise_conv as dc

    x, g, _, _ = _depthwise_inputs(shape, torch.bfloat16, card, seed=11)
    first, second = dc.depthwise_conv_wgrad(x, g), dc.depthwise_conv_wgrad(x, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("grid,cell", [((4, 4, 2), (4, 4, 8)), ((4, 4), (8, 8))])
def test_masked_conv_block_on_the_sparse_path_equals_the_dense_one_on_the_card(card, grid, cell):
    """A MaskedConvBlock in f32 on the card: its outputs at the visible cells and the gradients of its
    parameters are the same on the sparse MAE path (the visible cells, densified around the depthwise
    kernels) as on the dense path with the mask multiply."""
    from cinema_tpu_torch.models.layers import MaskedConvBlock
    from cinema_tpu_torch.ops.sparse_cells import CellDenseCtx, gather_cells, image_to_cells

    torch.manual_seed(0)
    nd, batch, chans = len(grid), 2, 32
    block = MaskedConvBlock(nd, chans).to(card)
    n_cells = int(np.prod(grid))
    rng = np.random.default_rng(3)
    keep = np.sort(np.stack([rng.permutation(n_cells)[: n_cells // 4] for _ in range(batch)]), axis=1)
    keep_ids = torch.from_numpy(keep).to(card)
    spatial = tuple(g * c for g, c in zip(grid, cell))
    x = torch.randn((batch, chans, *spatial), device=card)
    x = x.contiguous(memory_format=torch.channels_last_3d if nd == 3 else torch.channels_last)
    visible = torch.zeros((batch, n_cells), dtype=torch.bool, device=card).scatter_(1, keep_ids, True)
    mask = visible.reshape(batch, *grid)
    for axis, c in enumerate(cell):
        mask = mask.repeat_interleave(c, dim=axis + 1)

    def cells(t):  # (batch, chans, *spatial) -> the visible cells (batch * k, chans, *cell)
        return gather_cells(image_to_cells(t.movedim(1, -1), grid), keep_ids).flatten(0, 1).movedim(-1, 1)

    r = torch.randn_like(cells(x))
    params = list(block.parameters())
    before = trace.counter("depthwise.launches")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the block's 1x1 convolutions in full f32 on both paths
    try:
        dense = cells(block(x, mask))
        sparse = block(cells(x), None, dense_ctx=CellDenseCtx(grid_size=grid, keep_ids=keep_ids))
        grads_dense = torch.autograd.grad((dense * r).sum(), params)
        grads_sparse = torch.autograd.grad((sparse * r).sum(), params)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert trace.counter("depthwise.launches") == before + 2
    torch.testing.assert_close(sparse, dense, rtol=1e-5, atol=1e-5)
    for a, b in zip(grads_sparse, grads_dense):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item() + 1e-6
