"""Collectives over one axis of the rank grid (``parallel/mesh.py``), with
their gradients: what ``jax.lax.ppermute`` and ``psum`` are to the JAX
package's ``shard_map`` steps, and the two operators that GSPMD places for
its tensor-parallel step (Megatron's ``f`` and ``g``).

- ``permute(x, axis, shift)``: rank ``i`` of the axis sends ``x`` to rank
  ``i + shift`` and returns what rank ``i - shift`` sent (indices mod the
  axis size). Its backward is the reverse permute, the transpose of
  ``ppermute``.
- ``copy_to(x, axis)``: identity forward, all-reduce of the gradient
  backward (Megatron's ``f``, in front of a column-parallel layer).
- ``reduce_from(x, axis)``: all-reduce forward, identity backward
  (Megatron's ``g``, behind a row-parallel layer).
- ``all_to_all(x, axis, split_axis, concat_axis)``: the tiled
  ``jax.lax.all_to_all``: ``x`` is split along ``split_axis`` into
  ``axis.size`` chunks, chunk ``j`` goes to axis index ``j``, and the
  chunks received are concatenated along ``concat_axis`` in source order.
  Its backward is the reverse all-to-all (the two axes swapped).
- ``all_reduce_(x, axis, op)``: an in-place all-reduce outside autograd
  (gradients, loss sums, the row max of the vocab-parallel
  cross-entropy); ``all_reduce_flat_`` does a list of tensors as one flat
  buffer.
- ``send`` / ``recv``: one pipeline hop (``parallel/pp.py``);
  ``all_gather_host``: every rank's tensor on the host, for a
  checkpoint's or an evaluation's gather.

The port's functions are written here rather than taken from
``torch.distributed.nn.functional``, whose backward rules have changed
between releases. Point-to-point transfers post the send and the receive
together (``isend`` + ``irecv``; on NCCL as one group,
``batch_isend_irecv``, since two ranks that each post a send before a
receive on one communicator would wait on each other), so a ring of two
ranks cannot deadlock. gloo moves point-to-point buffers from host memory
only, so a CUDA tensor is staged through a host copy on a gloo group, and
so is an all-to-all's buffer; an all-reduce hands gloo the CUDA tensor,
which gloo reduces through host memory itself. On NCCL every CUDA tensor
goes to the collective as it is.

``stats`` counts what this rank hands the backend: ``bytes_sent`` is the
payload of every send, all-reduce, all-to-all and all-gather (an
all-to-all counts its whole buffer, the chunk it keeps included; an
all-reduce of ``b``
bytes counts ``b``; a ring all-reduce over ``n`` ranks puts ``2 (n-1) /
n`` times that on the wire), ``calls`` the number of collectives; a
reader takes the difference across the work it measures. A collective
over an axis of one rank is no call and moves nothing.
"""

from typing import Dict

import torch
import torch.distributed as tdist

stats: Dict[str, int] = {"bytes_sent": 0, "calls": 0}


def _count(t: torch.Tensor) -> None:
    stats["bytes_sent"] += t.numel() * t.element_size()
    stats["calls"] += 1


def _staged(t: torch.Tensor, axis) -> bool:
    return t.is_cuda and tdist.get_backend(axis.group) == "gloo"


def sendrecv_start(x: torch.Tensor, axis, dst: int, src: int):
    """Post a send of ``x`` to axis index ``dst`` and a receive of a
    tensor of ``x``'s shape and type from axis index ``src``, both at
    once; returns ``wait()``, which completes both and gives the received
    tensor on ``x``'s device. Work issued between the two overlaps the
    transfer."""
    if axis.size == 1:
        return lambda: x
    send = x.detach().contiguous()
    if _staged(send, axis):
        send = send.cpu()
    recv = torch.empty_like(send)
    _count(send)
    if tdist.get_backend(axis.group) == "nccl":
        reqs = tdist.batch_isend_irecv([
            tdist.P2POp(tdist.isend, send, axis.ranks[dst], axis.group),
            tdist.P2POp(tdist.irecv, recv, axis.ranks[src], axis.group)])
    else:
        reqs = [tdist.isend(send, axis.ranks[dst], group=axis.group),
                tdist.irecv(recv, axis.ranks[src], group=axis.group)]

    def wait() -> torch.Tensor:
        for req in reqs:
            req.wait()
        return recv.to(x.device) if recv.device != x.device else recv

    return wait


def shift_start(x: torch.Tensor, axis, shift: int):
    """``permute`` outside autograd, posted (``sendrecv_start``)."""
    n = axis.size
    return sendrecv_start(x, axis, (axis.index + shift) % n,
                          (axis.index - shift) % n)


def shift_plain(x: torch.Tensor, axis, shift: int) -> torch.Tensor:
    """``permute`` outside autograd."""
    return shift_start(x, axis, shift)()


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return shift_plain(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return shift_plain(g, ctx.axis, -ctx.shift), None, None


def permute(x: torch.Tensor, axis, shift: int) -> torch.Tensor:
    return x if axis.size == 1 else _Permute.apply(x, axis, shift)


def all_to_all_plain(x: torch.Tensor, axis, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """``all_to_all`` outside autograd."""
    n = axis.size
    if n == 1:
        return x
    moved = x.detach().movedim(split_axis, 0)
    if moved.shape[0] % n:
        raise ValueError(f"all_to_all: dimension {split_axis} of "
                         f"{tuple(x.shape)} does not split into {n} chunks")
    send = moved.reshape(n, moved.shape[0] // n, *moved.shape[1:])
    send = send.cpu().contiguous() if _staged(x, axis) else send.contiguous()
    recv = torch.empty_like(send)
    _count(send)
    tdist.all_to_all_single(recv, send, group=axis.group)
    recv = recv.to(x.device)
    return torch.cat([c.movedim(0, split_axis) for c in recv.unbind(0)],
                     dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        ctx.axis, ctx.axes = axis, (split_axis, concat_axis)
        return all_to_all_plain(x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (all_to_all_plain(g, ctx.axis, concat_axis, split_axis),
                None, None, None)


def all_to_all(x: torch.Tensor, axis, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all over ``axis``, differentiable."""
    return x if axis.size == 1 else _AllToAll.apply(x, axis, split_axis,
                                                    concat_axis)


def all_reduce_(x: torch.Tensor, axis,
                op=tdist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` over the axis in place and return it."""
    if axis.size > 1:
        _count(x)
        tdist.all_reduce(x, op=op, group=axis.group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """Identity forward, gradient all-reduced over ``axis`` backward."""
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """All-reduce over ``axis`` forward, identity backward."""
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def all_reduce_flat_(tensors, axis, divisor=None) -> None:
    """All-reduce a list of tensors over ``axis`` as one flat buffer, then
    divide each by ``divisor`` when given; in place."""
    tensors = list(tensors)
    if not tensors:
        return
    if axis.size > 1:
        flat = torch.cat([t.reshape(-1) for t in tensors])
        all_reduce_(flat, axis)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
    if divisor is not None:
        for t in tensors:
            t.div_(divisor)


def all_gather_host(t: torch.Tensor, axis) -> list:
    """Every rank's ``t`` (one shape on every rank), in axis order, on the
    host of each rank of ``axis``. The gather runs where ``t`` lies on
    NCCL (a host ``t`` goes to this rank's card first) and through host
    memory on gloo, which gathers host tensors only: a CUDA ``t`` visits
    the host before the gather there and only after it on NCCL."""
    t = t.detach().contiguous()
    if axis.size == 1:
        return [t.cpu()]
    if tdist.get_backend(axis.group) == "nccl":
        if not t.is_cuda:
            t = t.cuda()
    else:
        t = t.cpu()
    out = [torch.empty_like(t) for _ in range(axis.size)]
    _count(t)
    tdist.all_gather(out, t, group=axis.group)
    return [o.cpu() for o in out]


def send(x: torch.Tensor, axis, dst: int):
    """Post a send of ``x`` to axis index ``dst``; returns a handle whose
    ``wait()`` completes it (the host copy stays alive until then)."""
    buf = x.detach().contiguous()
    if _staged(buf, axis):
        buf = buf.cpu()
    _count(buf)
    work = tdist.isend(buf, axis.ranks[dst], group=axis.group)
    return _Pending(work, buf)


def recv(like: torch.Tensor, axis, src: int) -> torch.Tensor:
    """Receive a tensor of ``like``'s shape and type from axis index
    ``src``, onto ``like``'s device."""
    buf = torch.empty_like(like)
    if _staged(buf, axis):
        buf = torch.empty_like(like, device="cpu")
    tdist.recv(buf, axis.ranks[src], group=axis.group)
    return buf.to(like.device)


class _Pending:
    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()
        self.buf = None
