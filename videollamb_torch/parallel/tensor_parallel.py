"""The products of tensor-parallel weights, for the model code.

``parallel/sharding.shard_params`` leaves a tensor-parallel weight as a
``DTensor`` sharded over the mesh's ``model`` axis (under FSDP, the layer's
gathered weight during its forward is that DTensor). These helpers compute
with it on the rank's local shard, Megatron style, with DTensor's autograd
doing the collectives:

- a column-parallel weight (output features sharded): the input is
  replicated, the output is this rank's slice of the features; the input's
  gradient is summed over the ranks;
- a row-parallel weight (input features sharded): the input is this rank's
  slice of the features, the output is summed over the ranks;
- a vocabulary-parallel table: each rank looks up the ids in its rows and
  the lookups are summed.

On a plain tensor every helper is the plain product, so the unsharded model
pays one ``isinstance`` check a call. No kernel sees a DTensor: the
attention cores get this rank's heads.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor as is."""
    return t.to_local() if isinstance(t, DTensor) else t


def tp_matmul(x: torch.Tensor, w: torch.Tensor,
              partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` for a (d_in, d_out) ``w``, the product in x's dtype.

    A DTensor ``w`` sharded on d_out is column parallel (x replicated; the
    output is this rank's features); sharded on d_in it is row parallel (x
    holds this rank's input features; the output is summed over the ranks).
    ``partial``, a term of the output's shape on this rank, is added before
    a row-parallel sum, so that one all-reduce sums both (a LoRA delta
    computed from this rank's input features); otherwise after the product."""
    if not isinstance(w, DTensor):
        y = torch.matmul(x, w.to(x.dtype))
    else:
        mesh = w.device_mesh
        (placement,) = w.placements
        w = w.to(x.dtype)
        if placement == Shard(0):
            y = torch.matmul(x, w.to_local())
            if partial is not None:
                y = y + partial
            return DTensor.from_local(y, mesh, [Partial()], run_check=False).full_tensor()
        if placement == Shard(1):
            x_d = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
            y = torch.matmul(x_d, w).to_local()
        else:
            y = torch.matmul(x, w.to_local())
    return y if partial is None else y + partial


def tp_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
              gather: bool = False, partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear`` with an (out, in) ``weight`` and ``bias`` cast to x's dtype,
    where ``weight`` may be tensor parallel (see :func:`tp_matmul`, which
    also takes ``partial``). A column-parallel bias is sharded with the
    outputs; a row-parallel one is replicated and added after the sum."""
    if not isinstance(weight, DTensor):
        y = F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))
        return y if partial is None else y + partial
    column = weight.placements[0] == Shard(0)
    y = tp_matmul(x, weight.t(), partial)
    if bias is not None:
        y = y + local(bias).to(x.dtype)
    if gather and column:
        y = DTensor.from_local(y, weight.device_mesh, [Shard(y.ndim - 1)],
                               run_check=False).full_tensor()
    return y


def tp_embedding(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; a DTensor table sharded on its rows is vocabulary
    parallel (masked lookups summed over the ranks)."""
    if not isinstance(table, DTensor):
        return table[ids]
    ids_d = DTensor.from_local(ids, table.device_mesh, [Replicate()], run_check=False)
    return F.embedding(ids_d, table).full_tensor()
