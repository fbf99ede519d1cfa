"""Multi-tensor AdamW: the optimizer's accumulation, squared norm and update
over all its tensors at once (``parallel/optimizer.py`` calls these).

``multi_tensor_accumulate``, ``multi_tensor_sq_norm`` and
``multi_tensor_adamw`` are the wrappers of the CUDA kernels in
``csrc/multi_tensor_adamw.cu``, which replace no TPU kernel (XLA fuses
optax's chain on the TPU): they were added because dispatching some 20
PyTorch ops a tensor set the pace of the train step on the card.  Beside
each, the ``*_reference`` function is the plain version: the per-tensor
PyTorch loop, op for op what the kernels compute.  A wrapper runs the plain
version for CPU tensors only; for CUDA tensors it launches the kernel, or
``Tensors`` raised when it was built: the kernels take float32 and bfloat16
parameters (gradients and accumulators in the parameter's dtype), with or
without float32 masters, and float32 moments, all contiguous.

The kernels read one int64 row a tensor (``COLUMNS``: pointers, element
count, dtype code), at most ``MAX_TENSORS`` rows a launch (``chunks``); the
pointers of the optimizer's own tensors are packed once (``pack``: the
optimizer hands them out read-only, so nothing rebinds them), the
gradients' and the parameters' (the model's, whose storage may be replaced)
again at each call.  A missing gradient
(None) counts as zeros: a null pointer.  Nothing here allocates or syncs
per call; the clip factor is read on the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

MAX_TENSORS = 512  # rows one launch takes (kMaxTensors)
MAX_BLOCKS = 4 * 132  # a launch's grid at most: the norm's partial sums a launch (kMaxBlocks)
COLUMNS = ("grad", "param", "master", "mu", "nu", "acc", "numel", "dtype")
GRAD, PARAM = COLUMNS.index("grad"), COLUMNS.index("param")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def pack(params: Sequence, masters: Sequence, mus: Sequence, nus: Sequence, accs: Sequence,
         numels: Sequence[int], dtypes: Sequence[torch.dtype]):
    """The kernels' table of one tensor list: (rows, kept), rows an int64
    [len(kept), 8] array in ``COLUMNS`` order (gradient pointers 0 until
    ``set_column``), kept the list's indices of the non-empty tensors (an
    empty one has nothing to update and no row).  Pointers are ints, 0 for a
    missing master or accumulator; raises TypeError for a dtype the kernels
    do not take."""
    rows, kept = [], []
    for i, dtype in enumerate(dtypes):
        if dtype not in DTYPE_CODES:
            raise TypeError(f"the multi-tensor AdamW kernels take float32 and bfloat16 "
                            f"parameters, got {dtype}")
        if numels[i]:
            rows.append((0, params[i], masters[i], mus[i], nus[i], accs[i], numels[i],
                         DTYPE_CODES[dtype]))
            kept.append(i)
    return np.array(rows, dtype=np.int64).reshape(len(rows), len(COLUMNS)), kept


def chunks(rows: np.ndarray) -> List[np.ndarray]:
    """The table cut into launches of at most ``MAX_TENSORS`` rows: views,
    so a column set on the table is set in every chunk."""
    return [rows[i:i + MAX_TENSORS] for i in range(0, len(rows), MAX_TENSORS)]


def set_column(rows: np.ndarray, kept: Sequence[int], column: int, tensors: Sequence,
               dtypes: Sequence[torch.dtype]) -> None:
    """Write the kept tensors' pointers into ``column`` (0 for None), each
    tensor contiguous and of its row's dtype (``dtypes``, by list index)."""
    ptrs = []
    for i in kept:
        t = tensors[i]
        if t is None:
            ptrs.append(0)
            continue
        if t.dtype != dtypes[i] or not t.is_contiguous():
            raise ValueError(f"tensor {i} of the list is not a contiguous {dtypes[i]} tensor")
        ptrs.append(t.data_ptr())
    rows[:, column] = ptrs


class Tensors:
    """One optimizer's tensors in one order: parameters, float32 masters
    (None, or one a parameter), the moments mu and nu, accumulators (None,
    or one a parameter).  On a CUDA device also the kernels' table of them,
    checked and packed once, and the norm's scratch: ``partials``
    (``MAX_BLOCKS`` float64 partial sums a launch; the slots a launch's
    smaller grid leaves stay 0) and ``sq``, the squared norm."""

    def __init__(self, params: list, master: Optional[list], mu: list, nu: list,
                 acc: Optional[list]):
        self.params, self.master, self.mu, self.nu, self.acc = params, master, mu, nu, acc
        devices = {t.device for t in params}
        kinds = {d.type for d in devices}
        if len(devices) > 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"multi-tensor AdamW runs on the tensors of one cpu or cuda "
                             f"device, got {sorted(map(str, devices))}")
        self.rows = None
        if kinds != {"cuda"}:
            return
        n = len(params)
        master = master or [None] * n
        acc = acc or [None] * n
        for i, p in enumerate(params):
            own = [t for t in (master[i], mu[i], nu[i], acc[i]) if t is not None]
            if not all(t.is_contiguous() and t.device == p.device for t in (p, *own)):
                raise ValueError("multi-tensor AdamW takes contiguous tensors of one device")
            if any(t.dtype != torch.float32 for t in (mu[i], nu[i], master[i]) if t is not None):
                raise TypeError("multi-tensor AdamW takes float32 moments and masters")
            if acc[i] is not None and acc[i].dtype != p.dtype:
                raise TypeError(f"an accumulator is {acc[i].dtype}, its parameter {p.dtype}")
            if any(t.numel() != p.numel() for t in own):
                raise ValueError("an optimizer tensor's size is not its parameter's")
        ptr = [[0 if t is None else t.data_ptr() for t in ts] for ts in (params, master, mu, nu,
                                                                          acc)]
        self.dtypes = [p.dtype for p in params]
        self.rows, self.kept = pack(*ptr, [p.numel() for p in params], self.dtypes)
        self.chunks = chunks(self.rows)
        self.partials = torch.zeros(len(self.chunks) * MAX_BLOCKS, dtype=torch.float64,
                                    device=params[0].device)
        self.sq = torch.zeros((), dtype=torch.float32, device=params[0].device)
        self.stream_device = params[0].device

    @property
    def on_cuda(self) -> bool:
        return self.rows is not None

    def point_grads(self, grads: Sequence) -> None:
        """Put the gradients' pointers (0 for None) into the table; each of
        its parameter's shape (as ``.grad``'s setter holds it to it)."""
        set_column(self.rows, self.kept, GRAD, grads, self.dtypes)

    def point_params(self) -> None:
        """Put the parameters' pointers into the table again (their storage
        may have been replaced since the last call)."""
        set_column(self.rows, self.kept, PARAM, self.params, self.dtypes)

    def stream(self) -> int:
        return torch.cuda.current_stream(self.stream_device).cuda_stream


def _zeros_for_none(grads: Sequence, like: Sequence) -> list:
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, like)]


def multi_tensor_accumulate_reference(ts: Tensors, grads: Sequence, n_seen: int) -> None:
    """Plain version: acc <- acc + (g - acc) / (n_seen + 1) in each
    accumulator's dtype (a None gradient: zeros)."""
    for acc, g in zip(ts.acc, _zeros_for_none(grads, ts.params)):
        acc.copy_(acc + (g - acc) / (n_seen + 1))


def multi_tensor_accumulate(ts: Tensors, grads: Sequence, n_seen: int) -> None:
    """Fold one micro-step's gradients into the running mean of ``n_seen``
    earlier ones.  CUDA tensors: one kernel launch a chunk (counted in
    ``multi_tensor_accumulate.launches``, once a call); CPU tensors: the
    plain version."""
    if not ts.on_cuda:
        return multi_tensor_accumulate_reference(ts, grads, n_seen)
    if ts.acc is None:
        raise ValueError("this optimizer keeps no accumulators")
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    ts.point_grads(grads)
    lib, stream = kernels(), ts.stream()
    for rows in ts.chunks:
        check(lib.mcl_multi_tensor_accumulate(rows.ctypes.data, len(rows), n_seen, stream),
              "multi_tensor_accumulate")
    multi_tensor_accumulate.launches += 1


def multi_tensor_sq_norm_reference(ts: Tensors, grads: Optional[Sequence]) -> torch.Tensor:
    """Plain version: the float32 sum of each tensor's sum of g^2, in the
    list's order (``grads`` None: the accumulators)."""
    total = None
    for g in _zeros_for_none(ts.acc if grads is None else grads, ts.params):
        sq = torch.sum(g.float() * g.float())
        total = sq if total is None else total + sq
    return total


def multi_tensor_sq_norm(ts: Tensors, grads: Optional[Sequence]) -> torch.Tensor:
    """The squared global norm of ``grads`` (None: the accumulators), a
    float32 scalar tensor on their device.  CUDA tensors: a float64 partial
    sum a block, then their sum in a fixed order, rounded to float32
    (deterministic; counted in ``multi_tensor_sq_norm.launches``), into
    ``ts.sq``, valid until the next call; CPU tensors: the plain version."""
    if not ts.on_cuda:
        return multi_tensor_sq_norm_reference(ts, grads)
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    if grads is not None:
        ts.point_grads(grads)
    lib, stream = kernels(), ts.stream()
    base, width = ts.partials.data_ptr(), ts.partials.element_size()
    for c, rows in enumerate(ts.chunks):
        check(lib.mcl_multi_tensor_sq_norm(rows.ctypes.data, len(rows), int(grads is None),
                                           base + c * MAX_BLOCKS * width, MAX_BLOCKS, stream),
              "multi_tensor_sq_norm")
    check(lib.mcl_multi_tensor_sum(base, ts.partials.numel(), ts.sq.data_ptr(), stream),
          "multi_tensor_sq_norm")
    multi_tensor_sq_norm.launches += 1
    return ts.sq


def multi_tensor_adamw_reference(ts: Tensors, grads: Optional[Sequence],
                                 sq_norm: Optional[torch.Tensor], *, max_norm: float, b1: float,
                                 b2: float, eps: float, weight_decay: float, bc1: float,
                                 bc2: float, step_size: float) -> None:
    """Plain version: per tensor, the gradient (``grads`` None: the
    accumulator, zeroed once used) in float32, clipped as optax does when
    ``sq_norm`` is given, then AdamW into the master (its rounding written
    back to the parameter) or the parameter."""
    source = ts.acc if grads is None else grads
    if sq_norm is not None:
        norm = torch.sqrt(sq_norm)
        keep = norm < max_norm
    for i, (p, g) in enumerate(zip(ts.params, _zeros_for_none(source, ts.params))):
        g = g.float()
        if sq_norm is not None:
            g = torch.where(keep, g, (g / norm) * max_norm)
        mu, nu = ts.mu[i], ts.nu[i]
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        target = ts.master[i] if ts.master is not None else p
        upd = (upd + weight_decay * target.float()) * step_size
        target.add_(upd)
        if ts.master is not None:
            p.copy_(target.to(p.dtype))
        if grads is None:
            ts.acc[i].zero_()


def multi_tensor_adamw(ts: Tensors, grads: Optional[Sequence], sq_norm: Optional[torch.Tensor],
                       *, max_norm: float, b1: float, b2: float, eps: float, weight_decay: float,
                       bc1: float, bc2: float, step_size: float) -> None:
    """One AdamW update of every parameter from ``grads`` (None: the
    accumulators, which it zeroes), clipped by ``sq_norm`` (a float32
    scalar tensor of the squared global norm; None: no clipping) against
    ``max_norm``; ``bc1``, ``bc2`` the bias corrections, ``step_size`` -lr.
    CUDA tensors: one kernel launch a chunk (counted in
    ``multi_tensor_adamw.launches``, once a call); CPU tensors: the plain
    version."""
    hyper = dict(max_norm=max_norm, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, bc1=bc1,
                 bc2=bc2, step_size=step_size)
    if not ts.on_cuda:
        return multi_tensor_adamw_reference(ts, grads, sq_norm, **hyper)
    if grads is None and ts.acc is None:
        raise ValueError("this optimizer keeps no accumulators")
    if sq_norm is not None and not (sq_norm.dtype == torch.float32 and sq_norm.numel() == 1
                                    and sq_norm.device == ts.stream_device):
        raise ValueError("sq_norm must be one float32 value on the parameters' device")
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    if grads is not None:
        ts.point_grads(grads)
    ts.point_params()
    lib, stream = kernels(), ts.stream()
    sq = 0 if sq_norm is None else sq_norm.data_ptr()
    for rows in ts.chunks:
        check(lib.mcl_multi_tensor_adamw(rows.ctypes.data, len(rows), int(grads is None), sq,
                                         max_norm or 0.0, b1, b2, 1 - b1, 1 - b2, bc1, bc2, eps,
                                         weight_decay, step_size, stream),
              "multi_tensor_adamw")
    multi_tensor_adamw.launches += 1


multi_tensor_accumulate.launches = 0
multi_tensor_sq_norm.launches = 0
multi_tensor_adamw.launches = 0

__all__ = [
    "COLUMNS",
    "MAX_BLOCKS",
    "MAX_TENSORS",
    "Tensors",
    "chunks",
    "multi_tensor_accumulate",
    "multi_tensor_accumulate_reference",
    "multi_tensor_adamw",
    "multi_tensor_adamw_reference",
    "multi_tensor_sq_norm",
    "multi_tensor_sq_norm_reference",
    "pack",
    "set_column",
]
