"""Multi-device scoring over a (batch, space) grid of ranks: pairs over
``batch``, image rows over ``space``.

Counterpart of ``colorvideovdp_tpu/parallel/sharding.py``, written for
``torch.distributed`` as SPMD code: every rank runs the same program on its
own slab, and the collectives are explicit. A rank holds the raw blocks of
its pairs and rows, (B / n_batch, F, 3, H / n_space, W), which the metric's
block producer (``cvvdp._raw_blocks``) reads, uploads and ingests as it does
on one device. Its steps:

* ingest: row-local, no collectives (the ingest kernel on the slab); the
  first block repeats frame 0 whatever ``temp_padding`` says, as the JAX
  package's sharded step does;
* each pyramid level that the JAX package's ``can_reduce_slab`` admits is
  reduced as a halo'd slab (``sharded_reduce``: 8 rows from each neighbour,
  the slab mode of the reduce kernel, then the vertical edge fixes on the
  first rank's first row and the last rank's last row); the first level it
  does not admit is gathered and reduced whole, and every level below it is
  replicated (the same on every rank of a space group);
* each interior band of a row-sharded level that passes ``band_shardable``
  takes the one-pass band kernel's halo mode (``band_pooled_halo``, in every
  contrast coding) on its
  slab of gi (``halo_rows``: 8 rows from each neighbour, the exclude-edge
  reflection at a global edge) and the rows of the next level gn its
  expand reads (``halo_gn``: 5 rows from each neighbour of a sharded gn);
  the kernel expands gn at each slab row's reflected global row. The ranks'
  pooled sums are summed over the space group, then normalised by the
  band's global size. The other bands, and the baseband, run whole on
  every rank and are not summed;
* ``Q`` is gathered over the batch group, so it is the same on every rank.

The collectives are ``all_gather`` and ``all_reduce`` only, no point-to-point
calls, so one code path serves NCCL with one rank per card, gloo with ranks
sharing a card and gloo on the CPU; with gloo, CUDA tensors are staged
through host memory. Every routing decision follows from global shapes, so
all ranks issue the same collectives in the same order.

Every configuration of the metric runs: the band kernel's, in every
contrast coding, as above; any other (another masking model or clamp, the
cross-channel mix off) gathers the block's rows (``gather_rows``) and runs
the single-device block, the generic chain, on every rank. An image's heatmap takes the halo mode's D
output on the halo bands (``band_pooled_d_halo``), each band's map pooled
over the channels on its rows, then gathered. The collectives are
``torch.autograd.Function``s (``_ExchangeRows``, ``_GatherRows``,
``_SumSpace``, ``_GatherBatch``), so ``shard_loss_fn`` differentiates the
same step: each halo row's gradient goes back to its owner, a gathered
level keeps the rank's rows, the space group's sum passes its gradient to
every rank's term unchanged, and a replicated level read by a halo band
(``_Partial``) sums the ranks' gradients. Channel dumps and a video's
heatmap raise under a mesh.
"""

from __future__ import annotations

import socket
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from ..ops.kernels import ingest as ing
from ..ops.kernels import band_pooled as bp
from ..ops.kernels import masking_fused as bm
from ..ops.kernels import pyramid_reduce as prd
from ..ops.pyramid import K5, _reduce_1d, expand_rows, gausspyr_reduce, reduce_slab_plain
from ..utils import spans
from .launch import rank_device

# Rows each rank takes from its neighbours for a slab reduce (the 5-tap
# filter needs 2; the JAX kernel's 8-row alignment sets 8).
REDUCE_HALO = 8


class Mesh:
    """A (batch, space) grid over the ranks of the default process group:
    rank = b * n_space + s. Holds this rank's coordinates (``b``, ``s``) and
    the groups of its row (``space_group``: the ranks that share its pairs)
    and of its column (``batch_group``). Every rank creates every group, in
    the same order; a group of one rank is not created."""

    def __init__(self, n_batch: int, n_space: int):
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n_batch * n_space != world:
            raise ValueError(f"mesh ({n_batch}, {n_space}) needs {n_batch * n_space} ranks, "
                             f"the process group has {world}")
        rank = dist.get_rank() if dist.is_initialized() else 0
        self.n_batch, self.n_space = n_batch, n_space
        self.b, self.s = divmod(rank, n_space)
        self.backend = dist.get_backend() if world > 1 else None
        self.space_group = self.batch_group = None
        # The last backward collective's token in a differentiable step
        # (``_chained``); ``sharded_levels`` starts each block's chain.
        self.token = None
        if n_space > 1:
            for b in range(n_batch):
                g = dist.new_group([b * n_space + s for s in range(n_space)])
                if b == self.b:
                    self.space_group = g
        if n_batch > 1:
            for s in range(n_space):
                g = dist.new_group([b * n_space + s for b in range(n_batch)])
                if s == self.s:
                    self.batch_group = g

    def __repr__(self):
        return f"Mesh(batch={self.n_batch}, space={self.n_space}, b={self.b}, s={self.s})"


def make_mesh(batch: int | None = None) -> Mesh:
    """A (batch, space) mesh over the n ranks of the default process group,
    with the JAX package's default split: ``batch = max(1, n // 4)`` batch
    groups, the rest over rows."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if batch is None:
        batch = max(1, n // 4)
    if n % batch:
        raise ValueError(f"{n} ranks do not split into {batch} batch groups")
    return Mesh(batch, n // batch)


def _slices(mesh: Mesh, B: int, H: int):
    if B % mesh.n_batch or H % mesh.n_space:
        raise ValueError(f"batch {B} and height {H} must divide by the mesh's "
                         f"({mesh.n_batch}, {mesh.n_space})")
    bl, hl = B // mesh.n_batch, H // mesh.n_space
    return slice(mesh.b * bl, (mesh.b + 1) * bl), slice(mesh.s * hl, (mesh.s + 1) * hl)


def image_pair_sharding(mesh: Mesh, raw_shape):
    """This rank's (batch, row) slices of raw image or video blocks
    (B, F, C, H, W)."""
    return _slices(mesh, int(raw_shape[0]), int(raw_shape[-2]))


video_block_sharding = image_pair_sharding


# ---------------------------------------------------------------------------
# Collectives


def _stage(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """gloo takes host memory: CUDA tensors go through the host."""
    x = x.contiguous()
    return x.cpu() if mesh.backend == "gloo" and x.is_cuda else x


def _all_gather(x: torch.Tensor, group, n: int, mesh: Mesh):
    src = _stage(x, mesh)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts]


def _all_reduce(x: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM, group=None):
    buf = _stage(x, mesh).clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def _exchange(x: torch.Tensor, r: int, mesh: Mesh):
    zeros = x.new_zeros(x.shape[:-2] + (r, x.shape[-1]))
    edges = torch.cat([x[..., :r, :], x[..., -r:, :]], dim=-2)
    parts = _all_gather(edges, mesh.space_group, mesh.n_space, mesh)
    above = parts[mesh.s - 1][..., r:, :] if mesh.s > 0 else zeros
    below = parts[mesh.s + 1][..., :r, :] if mesh.s < mesh.n_space - 1 else zeros
    return above, below


class _ExchangeRows(torch.autograd.Function):
    """``exchange_rows`` with its adjoint: each halo row's gradient goes back
    to the rank that owns the row and is added there (one ``all_gather`` of
    every rank's two halo gradients). ``token`` orders the backward passes
    that run collectives (this one's and ``_Partial``'s): each takes the
    previous one's token and gives a new one, so every rank runs them in
    the same order, the reverse of the forward's, whatever order the
    autograd engine finds the rest of the graph in."""

    @staticmethod
    def forward(ctx, x, token, r, mesh):
        ctx.r, ctx.mesh, ctx.shape = r, mesh, x.shape
        return (*_exchange(x, r, mesh), token.clone())

    @staticmethod
    @once_differentiable
    def backward(ctx, g_above, g_below, g_token):
        r, mesh = ctx.r, ctx.mesh
        parts = _all_gather(torch.cat([g_above, g_below], dim=-2), mesh.space_group,
                            mesh.n_space, mesh)
        dx = g_above.new_zeros(ctx.shape)
        if mesh.s > 0:  # the rank above read my first rows as its halo below
            dx[..., :r, :] += parts[mesh.s - 1][..., r:, :]
        if mesh.s < mesh.n_space - 1:  # the rank below read my last rows
            dx[..., -r:, :] += parts[mesh.s + 1][..., :r, :]
        return dx, g_token, None, None


def _chained(fn, x, mesh: Mesh, *args):
    """``fn.apply(x, token, *args, mesh)``, a Function whose backward runs a
    collective, with the step's token chain threaded through it."""
    token = mesh.token if mesh.token is not None else x.new_zeros((), requires_grad=True)
    *outs, mesh.token = fn.apply(x, token, *args, mesh)
    return outs


def exchange_rows(x: torch.Tensor, r: int, mesh: Mesh):
    """(above, below): the last ``r`` rows (axis -2) of the rank above and the
    first ``r`` of the rank below in this rank's space group, zeros at the
    global edges. One ``all_gather`` of every rank's edge rows;
    differentiable (``_ExchangeRows``)."""
    if mesh.n_space == 1:
        zeros = x.new_zeros(x.shape[:-2] + (r, x.shape[-1]))
        return zeros, zeros
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _exchange(x, r, mesh)
    return tuple(_chained(_ExchangeRows, x, mesh, r))


class _GatherRows(torch.autograd.Function):
    """The whole level from every rank's slab; the adjoint keeps this
    rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.h = mesh, x.shape[-2]
        return torch.cat(_all_gather(x, mesh.space_group, mesh.n_space, mesh), dim=-2)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        s, h = ctx.mesh.s, ctx.h
        return g[..., s * h:(s + 1) * h, :].contiguous(), None


class _SumSpace(torch.autograd.Function):
    """The sum over the space group. The adjoint is the identity: every rank
    evaluates the same loss from the summed total, so each passes the
    total's gradient to its own term (an ``all_reduce`` of the gradients
    would count it ``n_space`` times)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh, group=mesh.space_group)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return g, None


class _GatherBatch(torch.autograd.Function):
    """The whole batch from every batch group's pairs; the adjoint keeps
    this rank's pairs."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return torch.cat(_all_gather(x, mesh.batch_group, mesh.n_batch, mesh), dim=0)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        b, n = ctx.mesh.b, ctx.n
        return g[b * n:(b + 1) * n].contiguous(), None


class _Partial(torch.autograd.Function):
    """The identity from a replicated tensor (the same on every rank of the
    space group) into a computation whose result differs by rank and is
    summed over the space group later (a halo band's pooled sums). The
    adjoint sums the ranks' gradients, so that the replicated tensor's
    gradient is again the same on every rank; ``token`` as
    ``_ExchangeRows``'s."""

    @staticmethod
    def forward(ctx, x, token, mesh):
        ctx.mesh = mesh
        return x.view_as(x), token.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, g, g_token):
        return _all_reduce(g, ctx.mesh, group=ctx.mesh.space_group), g_token, None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole level on every rank of the space group (rows, axis -2);
    differentiable."""
    return x if mesh.n_space == 1 else _GatherRows.apply(x, mesh)


def sum_space(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the space group; differentiable."""
    return x if mesh.n_space == 1 else _SumSpace.apply(x, mesh)


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch (axis 0) on every rank of the batch group;
    differentiable."""
    return x if mesh.n_batch == 1 else _GatherBatch.apply(x, mesh)


# ---------------------------------------------------------------------------
# The pyramid under a mesh


class Level:
    """One Gaussian level under a mesh: ``x`` is this rank's row slab when
    ``sharded``, else the whole level, the same on every rank of the space
    group. ``H`` is the level's global row count."""

    def __init__(self, x: torch.Tensor, sharded: bool, H: int):
        self.x, self.sharded, self.H = x, sharded, H
        self._full = None if sharded else x

    def full(self, mesh: Mesh) -> torch.Tensor:
        """The whole level (gathered once)."""
        if self._full is None:
            self._full = gather_rows(self.x, mesh)
        return self._full


def slab_reducible(H_loc: int, W: int) -> bool:
    """The JAX package's ``can_reduce_slab`` (``ops/kernels/pyramid_reduce.py
    :256-261``): whether a level sharded into ``H_loc``-row slabs is reduced
    slab by slab. The kernel takes any even slab; the gate keeps the JAX
    routing, whose tile rule needs two row tiles."""
    if H_loc % 2 or not (H_loc >= 48 and 256 <= W <= 8192):
        return False
    th = min(128, max(8, ((H_loc - 16) // 2) // 8 * 8))
    return -(-(H_loc // 2) // th) >= 2


def sharded_reduce(x: torch.Tensor, mesh: Mesh, use_kernel: bool = True) -> torch.Tensor:
    """One level's reduce on this rank's slab (..., H_loc, W) -> (..., H_loc/2,
    ceil(W/2)): exchange 8 rows, reduce the (H_loc + 16)-row buffer without
    vertical edge corrections (the kernel's slab mode), then add those
    corrections, horizontally reduced, at the global edges only (the JAX
    package's ``_sharded_reduce``, ``ops/pyramid.py:167-251``). Within float
    rounding of the whole level's reduce: the first and last rows add the
    correction after the horizontal pass."""
    if x.shape[-2] % 2:
        raise ValueError(f"sharded_reduce: odd slab of {x.shape[-2]} rows")
    # Even slabs make an even global row count: the even branches of the
    # last-sample corrections (trap 1).
    above, below = exchange_rows(x, REDUCE_HALO, mesh)
    xh = torch.cat([above, x, below], dim=-2)
    y = prd.ReduceSlab.apply(xh, False) if use_kernel else reduce_slab_plain(xh, False)
    k0, k1, k4 = (float(K5[t]) for t in (0, 1, 4))

    def hrow(row):
        return _reduce_1d(row.unsqueeze(-2), -1, odd_correction=False).squeeze(-2)

    if mesh.s == 0:
        y[..., 0, :] += hrow(x[..., 0, :] * k1 + x[..., 1, :] * k0)
    if mesh.s == mesh.n_space - 1:
        y[..., -1, :] += hrow(x[..., -1, :] * k4)
    return y


def sharded_levels(image: torch.Tensor, n_levels: int, mesh: Mesh, use_kernel: bool = True):
    """The Gaussian pyramid of this rank's slab as ``Level`` objects: levels
    stay row-sharded while ``slab_reducible`` admits them; the first level it
    does not admit is gathered and reduced whole, and the levels below it
    are replicated. Every sharded block starts here, the checkpoint's
    recompute too, so a new chain of backward collectives
    (``_chained``) starts here."""
    mesh.token = None
    levels = [Level(image, mesh.n_space > 1, image.shape[-2] * mesh.n_space)]
    for _ in range(1, n_levels):
        lv = levels[-1]
        if lv.sharded and slab_reducible(lv.x.shape[-2], lv.x.shape[-1]):
            y = sharded_reduce(lv.x, mesh, use_kernel)
            levels.append(Level(y, True, y.shape[-2] * mesh.n_space))
        else:
            y = gausspyr_reduce(lv.full(mesh), use_kernel)
            levels.append(Level(y, False, y.shape[-2]))
    return levels


def expand_slab(gn: Level, mesh: Mesh, h: int, w: int) -> torch.Tensor:
    """This rank's rows [s h_loc, (s + 1) h_loc) of ``gausspyr_expand(gn,
    (h, w))``, h_loc = h / n_space, bit for bit (``ops/pyramid.py``
    ``expand_rows``). A sharded gn gives 1 row to each neighbour; a
    replicated one is read where the rows lie."""
    h_loc = h // mesh.n_space
    if gn.sharded:
        above, below = exchange_rows(gn.x, 1, mesh)
        src, row0 = torch.cat([above, gn.x, below], dim=-2), mesh.s * gn.x.shape[-2] - 1
    else:
        src, row0 = gn.x, 0
    y = torch.arange(mesh.s * h_loc, (mesh.s + 1) * h_loc, device=gn.x.device)
    return expand_rows(src, row0, gn.H, y, w)


def halo_gn(gn: Level, mesh: Mesh):
    """(rows, row0): the rows of gn that the expand of this rank's halo'd
    band slab reads (``halo_rows`` of the band, the reflection included),
    from global row ``row0`` on. A sharded gn gives ``GN_HALO_ROWS`` rows to
    each neighbour (zeros past a global edge, where the expand clamps and
    never reads them); a replicated one is passed whole (through
    ``_Partial``, whose adjoint sums the ranks' gradients)."""
    if not gn.sharded:
        if mesh.n_space > 1 and torch.is_grad_enabled() and gn.x.requires_grad:
            return _chained(_Partial, gn.x, mesh)[0], 0
        return gn.x, 0
    r = bp.GN_HALO_ROWS
    above, below = exchange_rows(gn.x, r, mesh)
    return torch.cat([above, gn.x, below], dim=-2), mesh.s * gn.x.shape[-2] - r


def halo_rows(x: torch.Tensor, mesh: Mesh, r: int = bm.HALO_ROWS) -> torch.Tensor:
    """This rank's slab with ``r`` neighbour rows above and below, and at a
    global edge the exclude-edge reflection (x[-k] = x[k]) that the
    single-device blur reads there."""
    above, below = exchange_rows(x, r, mesh)
    if mesh.s == 0:
        above = x[..., 1:r + 1, :].flip(-2)
    if mesh.s == mesh.n_space - 1:
        below = x[..., -r - 1:-1, :].flip(-2)
    return torch.cat([above, x, below], dim=-2)


def band_shardable(params, h: int, w: int, mesh: Mesh) -> bool:
    """The JAX package's ``_can_shard_bt`` (``masking_fused.py:546-551``):
    an interior band of global size (h, w) takes the halo mode when the
    masking blur applies, the rows split evenly into slabs of at least 16
    and the blur radius fits in the halo. The TPU kernel's tile rule has no
    counterpart: the card's kernel takes any width."""
    ks = params.pu_kernel_size
    return (mesh.n_space > 1 and params.blurs(h, w) and h % mesh.n_space == 0
            and h // mesh.n_space >= 16 and ks % 2 == 1 and (ks - 1) // 2 <= bm.HALO_ROWS)


# ---------------------------------------------------------------------------
# Scoring steps


def _check_metric(metric, video: bool = False):
    if metric.dump_channels:
        raise ValueError("channel dumps take no mesh")
    if video and metric.do_heatmap:
        raise ValueError("the sharded video step gives no heatmap (the JAX package's discards "
                         "it); score the heatmap of a video on one device")


def shard_scoring_fn(metric, vid_source, met_colorspace, raw_shape, dtype, mesh: Mesh):
    """The image step under ``mesh``: ``fn(raw_t, raw_r) -> (Q_per_ch (B, C,
    1, bands), heatmap)``, both the same on every rank, where the raws are
    this rank's blocks (B / n_batch, 1, C, H / n_space, W) of the global
    ``raw_shape`` (``image_pair_sharding``), on the metric's device.
    ``heatmap`` is None unless the metric has one, else the float16 map
    (B, 1 or 3, 1, H, W) on the device, as ``predict`` draws it. ``dtype``
    keeps the JAX package's signature; the conversion reads the tensors'
    own."""
    _check_metric(metric)
    B, _, _, H, W = (int(v) for v in raw_shape)
    _slices(mesh, B, H)
    metric._ensure_pyramids(W, H)
    dm = vid_source.dm_photometry

    def fn(raw_t, raw_r):
        T = ing.raw_to_met(dm, raw_t, met_colorspace)
        R = ing.raw_to_met(dm, raw_r, met_colorspace)
        Q, hm, context = metric._process_block(ing.interleave_tr(T, R), temp_ch=1,
                                               is_image=True, heatmap=metric.do_heatmap,
                                               mesh=mesh)
        return Q, None if hm is None else metric._heatmap_map(hm, context)

    return fn


def shard_loss_fn(metric, height: int, width: int, mesh: Mesh, remat: bool = True):
    """The training step under ``mesh``, the counterpart of the JAX package's
    sharded gradient step (``__graft_entry__.py:115-140``): ``fn(test, ref)
    -> loss`` over this rank's slab (B / n_batch, 3, 1, height / n_space,
    width) of display-encoded float32 pairs on the metric's device. The
    loss, mean(10 - JOD) over the whole batch, is the same on every rank;
    its ``backward()`` leaves on each rank the gradient of the rank's own
    slab. ``get_loss_fn(mesh=)``: the colour conversion, the interleave,
    ``_process_block`` under ``torch.utils.checkpoint`` with ``remat``,
    the pooling, TF32 off."""
    _check_metric(metric)
    if height % mesh.n_space:
        raise ValueError(f"height {height} must divide by the mesh's {mesh.n_space} row slabs")
    return metric.get_loss_fn(height, width, remat=remat, mesh=mesh)


def ranks_on_device(device: torch.device) -> int:
    """How many ranks of the default group work on this rank's device (the
    host, for the CPU)."""
    if not dist.is_initialized():
        return 1
    key = (socket.gethostname(), str(device))
    keys = [None] * dist.get_world_size()
    dist.all_gather_object(keys, key)
    return keys.count(key)


def agreed_block_N(metric, pix_loc: int, N_frames: int, mesh: Mesh) -> int:
    """Frames per block: ``estimate_block_N`` on this rank's pixels with its
    share of the device's memory (the free memory over the ranks that share
    the device), then the least over all ranks (``all_reduce`` MIN), so that
    every rank runs the same blocks. The mesh's blocks follow the reference
    metric's memory model (``cvvdp._block_mem_model``)."""
    n = metric.estimate_block_N(pix_loc, N_frames, share=ranks_on_device(metric.device),
                                reference_model=True)
    if not dist.is_initialized():
        return n
    t = torch.tensor([n], dtype=torch.int64, device=metric.device)
    return int(_all_reduce(t, mesh, op=dist.ReduceOp.MIN).item())


def predict_video_source(metric, vid_source, mesh: Mesh):
    """Score a video source (an image is the one-frame case) under ``mesh``:
    every rank reads its pairs and rows of each block, and all get the same
    ``(Q_jod, stats)``. ``stats`` holds ``Q_per_ch``, ``block_N_frames``
    and ``block_loop_s``, the block loop's wall time on this rank (the
    device synchronised once, at its end); for an image with a heatmap
    metric also ``heatmap``, the host's float16 map (a video's is
    refused)."""
    with spans.request("cvvdp.predict") as root:
        return _predict_video_source(metric, vid_source, mesh, root)


def _predict_video_source(metric, vid_source, mesh: Mesh, root):
    h, w, N = vid_source.get_video_size()
    B = vid_source.get_batch_size()
    if vid_source.test_video.shape[0] != vid_source.reference_video.shape[0]:
        raise ValueError("sharded scoring needs test and reference batches of one size")
    bs, hs = _slices(mesh, B, h)
    is_image = N == 1
    _check_metric(metric, video=not is_image)
    metric._ensure_pyramids(w, h)
    t0 = time.time()
    block_N = 1
    if not is_image:
        metric._temporal_filters(vid_source)
        block_N = agreed_block_N(metric, (bs.stop - bs.start) * (hs.stop - hs.start) * w,
                                 N, mesh)
    Q_blocks, heatmap = [], None
    for _, cur, R, temp_ch in metric._raw_blocks(vid_source, N, block_N, bs.stop - bs.start,
                                                 metric.met_colorspace(), slab=(bs, hs)):
        Q, hm, context = metric._process_block(R, temp_ch=temp_ch, is_image=is_image,
                                               heatmap=metric.do_heatmap, mesh=mesh)
        del R
        Q_blocks.append(Q[:, :, :cur])
        if hm is not None:
            heatmap = metric._heatmap_map(hm, context)
    Q_per_ch = torch.cat(Q_blocks, dim=2) if len(Q_blocks) > 1 else Q_blocks[0]
    root.set(frames=N, block_N=block_N)
    if metric.device.type == "cuda":
        torch.cuda.synchronize(metric.device)
    loop_s = time.time() - t0
    Q_jod = metric.do_pooling_and_jods(Q_per_ch)
    stats = {"Q_per_ch": Q_per_ch.cpu().numpy(), "block_N_frames": block_N,
             "block_loop_s": loop_s, "width": w, "height": h, "N_frames": N}
    if heatmap is not None:
        stats["heatmap"] = heatmap.cpu().numpy()
    return Q_jod, stats


# ---------------------------------------------------------------------------
# Rank targets for ``launch.run_ranks``


def warm_up(mesh: Mesh, device: torch.device):
    """One collective on the default group and on each of this rank's mesh
    groups, so that their communicators exist before a timed run (NCCL makes
    a group's communicator at its first collective)."""
    if not dist.is_initialized():
        return
    for g in (None, mesh.space_group, mesh.batch_group):
        if g is not None or dist.get_world_size() > 1:
            _all_reduce(torch.zeros(1, device=device), mesh, group=g)


def score_rank(rank: int, world: int, spec: dict) -> dict:
    """Rank target: score the pair in ``spec`` under a mesh of ``world`` ranks, on
    the device ``launch.run_ranks`` gave this rank. ``spec``: ``test`` and
    ``reference``, paths of .npy arrays (read memory-mapped, so a rank reads
    only its rows), ``dim_order``, ``fps``, ``display_name``, and optionally
    ``batch`` (the mesh's batch groups), ``gpu_mem``, ``temp_padding``,
    ``enable_fused_kernels``, ``heatmap`` (an image's), and ``contrast``,
    ``masking_model`` or ``dclamp_type``, a configuration (the default
    parameters with those keys, written to a directory of the rank's own).
    With ``loss`` the arrays are display-encoded float32 (B, 3, 1, H, W)
    pairs and the rank runs ``shard_loss_fn`` steps instead (``steps``, 1 by
    default): it returns the loss and its slab's gradient. Returns the JOD,
    Q_per_ch, this rank's launches of every kernel wrapper, block length,
    set-up seconds (the mesh's groups, the metric, the kernel library and
    one collective on each group), block-loop seconds and
    peak device memory; with a heatmap the host's float16 map."""
    import shutil
    import tempfile

    from ..io.video_source import video_source_array
    from ..metrics.cvvdp import cvvdp
    from ..ops.kernels import _build, counted_wrappers
    from ..utils.config import write_parameters

    if "device" in spec:
        raise ValueError("score_rank: the rank's device is run_ranks's `device`, not spec's")
    t0 = time.time()
    dev = rank_device()
    mesh = make_mesh(spec.get("batch"))
    overrides = {k: spec[k] for k in ("contrast", "masking_model", "dclamp_type") if k in spec}
    cfg_dir = tempfile.mkdtemp(prefix="cvvdp_rank_") if overrides else None
    try:
        m = cvvdp(display_name=spec["display_name"], device=str(dev), quiet=True,
                  gpu_mem=spec.get("gpu_mem"), temp_padding=spec.get("temp_padding", "replicate"),
                  heatmap=spec.get("heatmap"),
                  config_paths=write_parameters(cfg_dir, **overrides) if overrides else None)
    finally:
        if cfg_dir:
            shutil.rmtree(cfg_dir, ignore_errors=True)
    m.enable_fused_kernels = spec.get("enable_fused_kernels", True)
    if dev.type == "cuda":
        _build.library()
    warm_up(mesh, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - t0
    test = np.load(spec["test"], mmap_mode="r")
    ref = np.load(spec["reference"], mmap_mode="r")
    counters = counted_wrappers()
    for fn in counters.values():
        fn.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"rank": rank, "b": mesh.b, "s": mesh.s,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    if spec.get("loss"):
        out.update(loss_step(m, test, ref, mesh, dev, spec.get("steps", 1)))
    else:
        vs = video_source_array(test, ref, spec["fps"], dim_order=spec["dim_order"],
                                display_photometry=m.display_photometry)
        Q, stats = predict_video_source(m, vs, mesh)
        out.update(jod=np.asarray(Q.cpu()), Q_per_ch=stats["Q_per_ch"],
                   block_N=stats["block_N_frames"], block_loop_s=stats["block_loop_s"],
                   heatmap=stats.get("heatmap"))
    out.update(setup_s=setup_s, route=m.sharded_route,
               launches={k: fn.launches for k, fn in counters.items()},
               peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    return out


def loss_step(metric, test, ref, mesh: Mesh, dev, steps: int = 1) -> dict:
    """``steps`` ``shard_loss_fn`` steps (forward and backward) on this
    rank's slab of the global (B, 3, 1, H, W) arrays ``test`` and ``ref``:
    the loss and the gradient of the rank's test slab (on the host) of the
    last, and each step's wall seconds (the device synchronised)."""
    B, H, W = test.shape[0], test.shape[-2], test.shape[-1]
    bs, hs = _slices(mesh, B, H)

    def slab(a):
        return torch.from_numpy(np.ascontiguousarray(a[bs, ..., hs, :], np.float32)).to(dev)

    r_loc = slab(ref)
    fn = shard_loss_fn(metric, H, W, mesh)
    step_s = []
    for _ in range(steps):
        t_loc = slab(test).requires_grad_()
        t0 = time.time()
        loss = fn(t_loc, r_loc)
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s.append(time.time() - t0)
    return {"loss": float(loss.detach()), "grad": t_loc.grad.cpu().numpy(), "step_s": step_s}


def reduce_rank(rank: int, world: int, x: np.ndarray, batch: int, use_kernel: bool) -> dict:
    """Rank target: ``sharded_reduce`` of this rank's slab of ``x`` (B, ..., H,
    W) under a mesh with ``batch`` batch groups; returns the rank's
    coordinates and its output slab."""
    mesh = make_mesh(batch)
    bs, hs = _slices(mesh, x.shape[0], x.shape[-2])
    loc = torch.from_numpy(np.ascontiguousarray(x[bs, ..., hs, :])).to(rank_device())
    return {"b": mesh.b, "s": mesh.s, "y": sharded_reduce(loc, mesh, use_kernel).cpu().numpy()}


def expand_rank(rank: int, world: int, gn: np.ndarray, h: int, w: int, batch: int) -> dict:
    """Rank target: ``expand_slab`` of a row-sharded ``gn`` (..., H_gn, W_gn)
    to this rank's rows of a (h, w) band; returns its coordinates and rows."""
    mesh = make_mesh(batch)
    hn_loc = gn.shape[-2] // mesh.n_space
    loc = torch.from_numpy(np.ascontiguousarray(
        gn[..., mesh.s * hn_loc:(mesh.s + 1) * hn_loc, :])).to(rank_device())
    E = expand_slab(Level(loc, True, gn.shape[-2]), mesh, h, w)
    return {"b": mesh.b, "s": mesh.s, "E": E.cpu().numpy()}
