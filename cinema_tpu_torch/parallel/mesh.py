"""The ('data', 'model') device mesh, the tensor-parallel rules and the parallel train state (port of
cinema_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a 2-D mesh and lets GSPMD place
every tensor. The port runs one process per card (torchrun) over a
``DeviceMesh`` of the same two axes (:func:`make_mesh`), and
:func:`parallelize` makes the model's layout explicit:

- data parallelism over ``data``: each rank's step takes its own rows, and
  the gradients are averaged over the data group before the update
  (``DistributedDataParallel``'s all-reduce; the port's step takes its
  gradients with ``torch.autograd.grad`` so that its NaN guard sees them
  before any update, and torch's DDP reduces only inside ``backward``, so
  the mean is one all-reduce of flat buckets after the gradients). The
  parameters start from data rank 0's, as DDP's do;
- FSDP (``mesh.fsdp``): FSDP2's ``fully_shard`` over ``data`` on every
  transformer block and on the model; parameters, gradients and optimizer
  state live as dim-0 shards (ZeRO-3; the JAX package shards the largest
  dimension of each large parameter instead: the same memory, another
  layout);
- tensor parallelism over ``model`` (``mesh.n_model`` > 1), Megatron's: the
  column layers (attention ``q`` and ``kv``, MLP ``fc1``, ``fc1_g``,
  ``fc1_x``) keep their rows of this rank, behind an input that is the
  identity forward and a sum over the model group backward; the row layers
  (``proj``, ``fc2``) keep their columns, and their partial products are
  summed over the model group before the bias. The fused ``kv`` projection
  orders its outputs (2, n_heads, head_dim), so a rank keeps the k rows and
  the v rows of its heads, ``[r H/n, (r+1) H/n)``, k first: its local kv is
  again (2, H/n, head_dim), and the packed attention kernel runs at local
  width E/n with H/n heads. An attention block whose heads ``n_model`` does
  not divide stays replicated (the numbers are the same either way).

:func:`param_spec` is the JAX package's rule table (``_param_spec`` and the
fallback of ``param_shardings``) on the port's names; :func:`parallelize`
shards the ``Dense`` layers of attention and MLP blocks that it calls column
or row. (It also calls the bias of a 1x1-convolution MLP a column, as the JAX
package shards it; a convolution stays replicated here.)

Every collective is a ``torch.distributed`` call on the tensor where it lies:
NCCL on the card, gloo on the CPU or where two processes share one card (NCCL
puts no two ranks on one device; gloo on torch 2.11 takes CUDA tensors in every
collective used here, FSDP2's included: ``chip_smoke.py``, phase 14).

Checkpoints are written from full tensors (:meth:`Parallel.full_state_dict`,
the kv order undone) in the single-process format, so a checkpoint moves
between a distributed run and a single-process one either way.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

DATA_AXIS = "data"
MODEL_AXIS = "model"
COLUMN, ROW, REPLICATED = "column", "row", "replicated"

_COLUMN_LAYERS = ("q", "kv", "fc1", "fc1_g", "fc1_x")
_ROW_LAYERS = ("proj", "fc2")
# the dimension of a torch parameter that a spec shards: a column layer's outputs (weight rows, bias), a row
# layer's inputs (weight columns); JAX's (in, out) kernel has them the other way round
_SHARD_DIM = {COLUMN: 0, ROW: 1}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device_type: str = "cuda"):
    """A ('data', 'model') ``DeviceMesh`` over the process group, one card per process: rank r has data
    coordinate ``r // n_model`` and model coordinate ``r % n_model``.

    ``n_data`` defaults to processes // n_model. Raises where the mesh needs more processes than the
    group has, and where it would leave processes out (each process drives one card of the mesh).
    """
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model > world:
        raise ValueError(f"mesh {n_data}x{n_model} needs more than {world} processes.")
    if n_data * n_model < world:
        raise ValueError(f"mesh {n_data}x{n_model} uses {n_data * n_model} of {world} processes: "
                         f"launch {n_data * n_model}, one per card of the mesh.")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def param_spec(name: str, param: torch.Tensor, n_model: int = 1) -> str:
    """``"column"``, ``"row"`` or ``"replicated"``: the JAX package's Megatron rule (``_param_spec``,
    cinema_tpu/parallel/mesh.py:71-89) on a torch parameter name. Under an ``attn`` or ``mlp`` module,
    the 2-D weight and the 1-D bias of ``q``, ``kv``, ``fc1``, ``fc1_g``, ``fc1_x`` are column, the 2-D
    weight of ``proj`` and ``fc2`` row; the rest replicated, and so is a parameter whose sharded
    dimension ``n_model`` does not divide (``param_shardings``' fallback)."""
    parts = name.split(".")
    leaf = parts[-1]
    spec = REPLICATED
    if "attn" in parts or "mlp" in parts:
        col = any(p in _COLUMN_LAYERS for p in parts)
        row = any(p in _ROW_LAYERS for p in parts)
        if col and ((leaf == "weight" and param.ndim == 2) or (leaf == "bias" and param.ndim == 1)):
            spec = COLUMN
        elif row and leaf == "weight" and param.ndim == 2:
            spec = ROW
    if spec != REPLICATED and param.shape[_SHARD_DIM[spec]] % n_model != 0:
        spec = REPLICATED
    return spec


class CopyToModel(torch.autograd.Function):
    """The input of a column-parallel layer: the identity forward; the backward sums the input's
    gradient over the model group (each rank holds the part from its own output columns)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class ReduceFromModel(torch.autograd.Function):
    """The output of a row-parallel layer: the forward sums the partial products over the model group;
    the backward is the identity (every rank needs the whole gradient of the sum)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class ColumnParallelDense(nn.Module):
    """A ``Dense`` layer's output rows ``rows``, computed in its input's dtype, behind ``CopyToModel``."""

    def __init__(self, dense: nn.Linear, rows: torch.Tensor, group) -> None:
        super().__init__()
        self.group = group
        with torch.no_grad():
            rows = rows.to(dense.weight.device)
            self.weight = nn.Parameter(dense.weight.index_select(0, rows).clone())
            self.bias = None if dense.bias is None else nn.Parameter(dense.bias.index_select(0, rows).clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = CopyToModel.apply(x, self.group)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class RowParallelDense(nn.Module):
    """A ``Dense`` layer's input columns ``cols``; the partial products are summed over the model group
    (``ReduceFromModel``) before the bias is added."""

    def __init__(self, dense: nn.Linear, cols: torch.Tensor, group) -> None:
        super().__init__()
        self.group = group
        with torch.no_grad():
            self.weight = nn.Parameter(dense.weight.index_select(1, cols.to(dense.weight.device)).clone())
            self.bias = None if dense.bias is None else nn.Parameter(dense.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = ReduceFromModel.apply(F.linear(x, self.weight.to(x.dtype)), self.group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def _rows(n: int, rank: int, size: int, kv: bool) -> torch.Tensor:
    """Rank ``rank``'s rows of a column layer of ``n`` outputs; of a fused kv projection, the k rows and
    then the v rows of its heads."""
    if not kv:
        per = n // size
        return torch.arange(rank * per, (rank + 1) * per)
    half = n // 2
    per = half // size
    own = torch.arange(rank * per, (rank + 1) * per)
    return torch.cat([own, half + own])


class Parallel:
    """A model's distributed layout (:func:`parallelize`) and what the train step needs of it: the
    reduced gradients, the global gradient norm, the finite-loss flag and the metrics agreed over the
    ranks, and full tensors for checkpoints.

    Attributes:
        n_data, n_model, data_rank, model_rank: the mesh's sizes and this rank's coordinates.
        fsdp: parameters are FSDP2 shards over ``data``.
        tp: name -> (dim, one index tensor per model rank, full shape) of each tensor-parallel parameter.
    """

    def __init__(self, mesh, fsdp: bool) -> None:
        self.mesh = mesh
        self.fsdp = fsdp
        self.n_data, self.n_model = mesh.size(0), mesh.size(1)
        self.data_rank, self.model_rank = mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(MODEL_AXIS)
        self.data_group, self.model_group = mesh.get_group(DATA_AXIS), mesh.get_group(MODEL_AXIS)
        self.tp: Dict[str, Tuple[int, List[torch.Tensor], torch.Size]] = {}
        self.partial: set = set()  # replicated parameters used on local heads: gradients summed over model
        self.local_shapes: Dict[str, torch.Size] = {}  # each parameter's shape before FSDP
        self.names: List[str] = []  # the parameters, in the model's (and the optimizer's) order

    # -- the layout ----------------------------------------------------------------------------------
    def _shard_tensor_parallel(self, model: nn.Module) -> None:
        from cinema_tpu_torch.models.vit import Attention, Mlp, SwiGLU

        n, r = self.n_model, self.model_rank

        def shard(prefix: str, module: nn.Module, attr: str, kv: bool = False) -> None:
            dense = getattr(module, attr)
            name = f"{prefix}.{attr}.weight"
            spec = param_spec(name, dense.weight, n)
            if spec == COLUMN:
                index = [_rows(dense.out_features, i, n, kv) for i in range(n)]
                setattr(module, attr, ColumnParallelDense(dense, index[r], self.model_group))
                self.tp[name] = (0, index, dense.weight.shape)
                if dense.bias is not None:
                    self.tp[f"{prefix}.{attr}.bias"] = (0, index, dense.bias.shape)
            else:
                index = [torch.arange(i * dense.in_features // n, (i + 1) * dense.in_features // n) for i in range(n)]
                setattr(module, attr, RowParallelDense(dense, index[r], self.model_group))
                self.tp[name] = (1, index, dense.weight.shape)

        for prefix, module in list(model.named_modules()):
            if isinstance(module, Attention):
                specs = [param_spec(f"{prefix}.{a}.weight", getattr(module, a).weight, n) for a in ("q", "kv", "proj")]
                if module.n_heads % n or specs != [COLUMN, COLUMN, ROW]:
                    continue  # replicated: the whole block computes on every rank
                shard(prefix, module, "q")
                shard(prefix, module, "kv", kv=True)
                shard(prefix, module, "proj")
                module.n_heads //= n
                self.partial |= {f"{prefix}.{k}" for k, _ in module.named_parameters()
                                 if k.startswith(("q_norm.", "k_norm."))}
            elif isinstance(module, (Mlp, SwiGLU)):
                cols = ["fc1"] if isinstance(module, Mlp) else ["fc1_g", "fc1_x"]
                specs = [param_spec(f"{prefix}.{a}.weight", getattr(module, a).weight, n) for a in (*cols, "fc2")]
                if specs != [COLUMN] * len(cols) + [ROW]:
                    continue
                for a in cols:
                    shard(prefix, module, a)
                shard(prefix, module, "fc2")

    def _shard_fsdp(self, model: nn.Module) -> None:
        from torch.distributed.fsdp import fully_shard

        from cinema_tpu_torch.models.vit import Block

        data_mesh = self.mesh[DATA_AXIS]
        for module in model.modules():
            if isinstance(module, Block):
                fully_shard(module, mesh=data_mesh)
        fully_shard(model, mesh=data_mesh)

    # -- the step ------------------------------------------------------------------------------------
    def optimizer_params(self, model: nn.Module) -> List[torch.Tensor]:
        """The tensors that the optimizer updates, in the model's parameter order: the parameters, or
        under FSDP their local shards (fetched anew each step: FSDP may swap them at its first forward)."""
        if not self.fsdp:
            return list(model.parameters())
        with torch.no_grad():
            return [p.to_local() for p in model.parameters()]

    def gradients(self, loss: torch.Tensor, model: nn.Module) -> List[torch.Tensor]:
        """The gradients of ``loss`` for :meth:`optimizer_params`, averaged over the data group and, for
        the parameters that are replicated but used on local heads, summed over the model group."""
        if self.fsdp:
            loss.backward()  # FSDP reduce-scatters inside backward: the mean over data, into each shard
            grads = []
            # the sharded parameters, read after backward: between forward and backward the root module
            # holds its unsharded ones
            for p, local in zip(list(model.parameters()), self.optimizer_params(model)):
                grads.append(torch.zeros_like(local) if p.grad is None else p.grad.to_local())
                p.grad = None
        else:
            params = list(model.parameters())
            grads = list(torch.autograd.grad(loss, params, allow_unused=True))
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
            if self.n_data > 1:
                _all_reduce_flat(grads, self.data_group, scale=1.0 / self.n_data)
        if self.n_model > 1:
            partial = [g for name, g in zip(self.names, grads) if name in self.partial]
            if partial:
                _all_reduce_flat(partial, self.model_group)
        return grads

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The norm of the whole gradient: the squares of tensor-parallel shards summed over the model
        group, of FSDP shards over the data group, each replicated gradient counted once."""
        from cinema_tpu_torch.train.fused_optim import _global_norm

        if not self.fsdp and self.n_model == 1:
            return _global_norm(grads)  # every rank holds every whole gradient
        squares = torch.stack(torch._foreach_norm([g.float() for g in grads])).square()
        sharded = torch.tensor([name in self.tp for name in self.names], device=squares.device)
        parts = torch.stack([squares[~sharded].sum(), squares[sharded].sum()])
        if self.fsdp:
            dist.all_reduce(parts, group=self.data_group)
        if self.n_model > 1:
            tp_squares = parts[1:].clone()
            dist.all_reduce(tp_squares, group=self.model_group)
            parts = torch.cat([parts[:1], tp_squares])
        return parts.sum().sqrt()

    def all_finite(self, loss: torch.Tensor) -> torch.Tensor:
        """Whether the loss is finite on every rank (a bool tensor): a batch is skipped everywhere or
        nowhere."""
        ok = torch.isfinite(loss.detach()).float().reshape(1)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        return ok[0] > 0

    def mean_metrics(self, metrics: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each scalar metric averaged over the data group, in its own dtype (tensor-parallel peers hold the
        same ones)."""
        if self.n_data == 1:
            return dict(metrics)
        keys = list(metrics)
        values = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        dist.all_reduce(values, group=self.data_group)
        values = values / self.n_data
        return {k: v.to(metrics[k].dtype) for k, v in zip(keys, values)}

    def broadcast_buffers(self, model: nn.Module) -> None:
        """Data rank 0's running statistics on every data rank (DDP's ``broadcast_buffers``)."""
        for module in model.modules():
            if isinstance(module, nn.modules.batchnorm._BatchNorm):
                for b in module.buffers():
                    dist.broadcast(b, group=self.data_group, group_src=0)

    # -- full tensors for checkpoints -----------------------------------------------------------------
    def full_tensor(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``local`` is this rank's part (a parameter, or a moment of one)."""
        t = local.to_local() if hasattr(local, "to_local") else local
        if self.fsdp and name in self.local_shapes:
            t = _gather_dim0(t, self.local_shapes[name], self.data_group, self.n_data)
        if name in self.tp:
            dim, index, shape = self.tp[name]
            full = t.new_empty(shape)
            for part, idx in zip(_all_gather(t, self.model_group), index):
                full.index_copy_(dim, idx.to(t.device), part)
            t = full
        return t

    def local_tensor(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``full``: the inverse of :meth:`full_tensor`."""
        t = full
        if name in self.tp:
            dim, index, _ = self.tp[name]
            t = t.index_select(dim, index[self.model_rank].to(t.device))
        if self.fsdp and name in self.local_shapes:
            t = _chunk_dim0(t, self.data_rank, self.n_data)
        return t

    def full_state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` as a single-process model has it (every rank takes part)."""
        return {k: self.full_tensor(k, v) for k, v in model.state_dict().items()}

    def load_full_state_dict(self, model: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
        """Copy a single-process ``state_dict`` into the model's local parts."""
        own = model.state_dict()
        missing = set(own) ^ set(state)
        if missing:
            raise KeyError(f"state_dict keys differ: {sorted(missing)[:5]}")
        with torch.no_grad():
            for k, v in own.items():
                dst = v.to_local() if hasattr(v, "to_local") else v
                dst.copy_(self.local_tensor(k, state[k].to(dst.device)))


def _all_reduce_flat(tensors: List[torch.Tensor], group, scale: Optional[float] = None) -> None:
    """Sum ``tensors`` over ``group`` in place, one flat buffer per dtype, times ``scale``."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group_tensors])
        dist.all_reduce(flat, group=group)
        if scale is not None:
            flat.mul_(scale)
        offset = 0
        for t in group_tensors:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()


def _all_gather(tensor: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``tensor`` (all of one shape), in group-rank order."""
    out = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, tensor.contiguous(), group=group)
    return out


def _chunk_dim0(full: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s dim-0 chunk of ``full`` as FSDP2 shards it (``torch.chunk``; empty past the last)."""
    chunks = torch.chunk(full, size, dim=0)
    if rank < len(chunks):
        return chunks[rank]
    return full.new_empty((0, *full.shape[1:]))


def _gather_dim0(local: torch.Tensor, shape: torch.Size, group, size: int) -> torch.Tensor:
    """The whole tensor of ``shape`` from every rank's dim-0 chunk (padded to one size to gather)."""
    per = -(-shape[0] // size)
    padded = local.new_zeros((per, *shape[1:]))
    padded[: local.shape[0]] = local
    return torch.cat(_all_gather(padded, group))[: shape[0]]


def parallelize(model: nn.Module, mesh, fsdp: bool = False) -> Parallel:
    """Lay ``model`` out over ``mesh`` in place (module docstring) and return its :class:`Parallel`.
    Every rank passes the same initial weights (the same seed)."""
    par = Parallel(mesh, fsdp)
    if par.n_model > 1:
        par._shard_tensor_parallel(model)
    par.names = [name for name, _ in model.named_parameters()]
    par.local_shapes = {name: p.shape for name, p in model.named_parameters()}
    if fsdp:
        par._shard_fsdp(model)
    else:
        with torch.no_grad():  # DDP's start: data rank 0's parameters and buffers
            for t in (*model.parameters(), *model.buffers()):
                dist.broadcast(t.data, group=par.data_group, group_src=0)
    return par
