"""Loader and wrapper of the hand-written CUDA MR¹ kernels.

The source is ``csrc/mr1_volumes.cu`` (see its header for the design and
what bounds it).  ``kernels/_build.py`` compiles it with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface at the first
CUDA call — never at import — and loads it with ``ctypes``.  When ``nvcc``
is missing or the build fails, a CUDA call raises: there is no fallback.

Three launches a call, each on PyTorch's current stream, none
synchronising: ``mr1_num`` (the num-arrays), ``mr1_probe_<dtype>`` (probes,
fact volume and contributions in one pass) and ``mr1_dimvol_<dtype>`` (the
dimension volumes).  Every exported C function takes one descriptor, a
host array of int64 words (:func:`descriptor`: the arrays' addresses and
sizes), and the stream, and returns ``cudaGetLastError()``; ``LIB.launch``
raises on anything but 0.  ``LAUNCHES`` counts launches per C function and
moves only where a kernel is launched.

The wrapper allocates everything: num-arrays and contribution planes
zeroed (one buffer each), the volumes empty (the kernels write every
slot).  No size depends on the data, so a call can be captured in a CUDA
graph.  Which contribution planes a probe block keeps in shared memory
follows from the key domains and the accumulator width
(:func:`shared_planes`); how a plane's fact slots are cut into blocks, from
the shapes (:func:`probe_shape`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import PTR

SOURCE = Path(__file__).resolve().parent / "csrc" / "mr1_volumes.cu"

#: accumulator dtype -> (probe C function, dimension-volume C function);
#: each C function's name is also its launch counter's
INSTANTIATIONS = {
    torch.int32: ("mr1_probe_int32", "mr1_dimvol_int32"),
    torch.int64: ("mr1_probe_int64", "mr1_dimvol_int64"),
}
NUM = "mr1_num"

#: C launcher -> argument kinds: the descriptor (host int64 array), stream
SYMBOLS = {name: (PTR, PTR) for name in
           (NUM, *(s for pair in INSTANTIATIONS.values() for s in pair))}

LIB = _build.Library("mr1_volumes", SOURCE, SYMBOLS, kernels=list(SYMBOLS))
#: launches per C function since the last ``LIB.reset_launches()``
LAUNCHES = LIB.launches

#: dimensions the kernels take (the source's kMaxDims)
MAX_DIMS = 8
#: shared-memory bytes a probe block may hold contribution planes in
SHARED_BYTES = 128 * 1024
#: a probe block's threads (the source's kProbeThreads), the threads and
#: shared memory an H100 SM holds, and its SMs
PROBE_THREADS, SM_THREADS, SM_SHARED_BYTES, SMS = 512, 2048, 228 * 1024, 132
#: fact slots a probe block takes at least, so that a block's shared
#: planes are zeroed and flushed for enough slots
MIN_CHUNK_ROWS = 8192
#: waves of probe blocks when no plane is shared (spreads the uneven work
#: of skewed keys); blocks with shared planes flush theirs once, one wave
WAVES = 4


def shared_planes(domains: Sequence[int],
                  itemsize: int) -> Tuple[List[int], int]:
    """``(offsets, bins)``: each dimension's offset, in bins, among a probe
    block's shared contribution bins, -1 where its plane stays in device
    memory, and the bins held.  In dimension order, a plane is shared when
    it fits what is left of ``SHARED_BYTES`` at ``itemsize`` bytes a bin."""
    offsets, bins = [], 0
    for dom in domains:
        if (bins + dom) * itemsize <= SHARED_BYTES:
            offsets.append(bins)
            bins += dom
        else:
            offsets.append(-1)
    return offsets, bins


def probe_shape(planes: int, rows: int, shared_bytes: int) -> Tuple[int, int]:
    """``(chunks, rows_per_chunk)`` of the probe launch: the blocks a
    plane's ``rows`` fact slots are cut into.  The grid aims at the blocks
    the SMs hold at once (fewer with ``shared_bytes`` of shared planes a
    block), ``WAVES`` times over when nothing is shared; a block takes at
    least ``MIN_CHUNK_ROWS`` slots."""
    resident = SM_THREADS // PROBE_THREADS
    if shared_bytes:
        resident = max(1, min(resident,
                              SM_SHARED_BYTES // (shared_bytes + 1024)))
    target = SMS * resident * (1 if shared_bytes else WAVES)
    chunks = max(1, min(-(-target // planes), -(-rows // MIN_CHUNK_ROWS)))
    return chunks, max(1, -(-rows // chunks))


def descriptor(words: Sequence[int]):
    """The int64 host array the C launchers read."""
    return (ctypes.c_int64 * len(words))(*words)


def _check(routed_fact, routed_dims, domains, dtype):
    fkeys, fmask = routed_fact
    dev = fmask.device
    if not fmask.is_cuda:
        raise ValueError(f"mr1_volumes kernel needs CUDA tensors, got {dev}")
    if dtype not in INSTANTIATIONS:
        raise TypeError(f"mr1_volumes has no kernel for {dtype} volumes "
                        f"(takes {sorted(map(str, INSTANTIATIONS))})")
    m = len(routed_dims)
    if len(domains) != m or m > MAX_DIMS:
        raise ValueError(f"need one domain per dimension and at most "
                         f"{MAX_DIMS} dimensions, got {m} dimensions and "
                         f"{len(domains)} domains")
    if fmask.dim() != 3:
        raise ValueError(f"need a fact mask [N, P, rows], got "
                         f"{tuple(fmask.shape)}")
    N, P, R = fmask.shape
    if fkeys.shape != (N, P, R, m):
        raise ValueError(f"need fact keys [N, P, rows, m] = "
                         f"{(N, P, R, m)}, got {tuple(fkeys.shape)}")
    if N * P > 65535:
        raise ValueError(f"{N * P} planes exceed the grid's y limit")
    for keys, mask in (routed_fact, *routed_dims):
        if keys.device != dev or mask.device != dev:
            raise ValueError(f"routed relations on {keys.device} / "
                             f"{mask.device}, fact on {dev}")
        if keys.dtype != torch.int32 or mask.dtype != torch.bool:
            raise TypeError(f"need int32 keys and bool masks, got "
                            f"{keys.dtype} and {mask.dtype}")
    for (keys, mask), dom in zip(routed_dims, domains):
        if (mask.dim() != 3 or mask.shape[:2] != (N, P)
                or keys.shape != mask.shape):
            raise ValueError(f"need dimension keys and mask [N, P, rows] "
                             f"with N, P = {N}, {P}, got {tuple(keys.shape)}"
                             f" and {tuple(mask.shape)}")
        if not 1 <= int(dom) < 2 ** 31:
            raise ValueError(f"key domain must be in [1, 2^31), got {dom}")


def mr1_volumes(routed_fact, routed_dims, domains: Sequence[int],
                dtype: torch.dtype):
    """MR¹ statistics on the card: the num-array, probe and dimension-volume
    launches over a CN batch's routed relations.

    ``routed_fact`` is ``(keys [N, P, R, m] int32, mask [N, P, R] bool)``,
    each of the ``m`` ``routed_dims`` ``(keys [N, P, R_i] int32, mask)``,
    ``domains`` their key domains -> ``(vol_fact [N, P, R], [vol_i [N, P,
    R_i]])`` in ``dtype`` (int32 or int64), bit for bit the plain version's
    (``ref.mr1_volumes``).  Raises on anything the kernels do not take."""
    _check(routed_fact, routed_dims, domains, dtype)
    fkeys, fmask = (t.contiguous() for t in routed_fact)
    dims = [tuple(t.contiguous() for t in d) for d in routed_dims]
    domains = [int(d) for d in domains]
    N, P, R = fmask.shape
    planes, dev, m = N * P, fmask.device, len(dims)
    itemsize = dtype.itemsize
    num = torch.zeros(planes * sum(domains), dtype=torch.int32, device=dev)
    contrib = torch.zeros(planes * sum(domains), dtype=dtype, device=dev)
    vol_fact = torch.empty((N, P, R), dtype=dtype, device=dev)
    dim_vols = [torch.empty(mask.shape, dtype=dtype, device=dev)
                for _, mask in dims]
    if planes * R == 0 and all(v.numel() == 0 for v in dim_vols):
        return vol_fact, dim_vols
    offsets, bins = shared_planes(domains, itemsize)
    chunks, rows_per_chunk = probe_shape(planes, R, bins * itemsize)
    words = [m, planes, fkeys.data_ptr(), fmask.data_ptr(),
             vol_fact.data_ptr(), R, rows_per_chunk, chunks, bins]
    at = 0
    for (keys, mask), vol, dom, off in zip(dims, dim_vols, domains, offsets):
        words += [keys.data_ptr(), mask.data_ptr(),
                  num.data_ptr() + 4 * planes * at,
                  contrib.data_ptr() + itemsize * planes * at,
                  vol.data_ptr(), mask.shape[2], dom, off]
        at += dom
    desc = descriptor(words)
    probe, dimvol = INSTANTIATIONS[dtype]
    if m:
        LIB.launch(NUM, NUM, dev, desc)
    if R:
        LIB.launch(probe, probe, dev, desc)
    if m:
        LIB.launch(dimvol, dimvol, dev, desc)
    return vol_fact, dim_vols
