"""Checkpointing: atomic, prunable, in the reference's on-disk format
(``repro.train.checkpoint``), so each package restores the other's.

Layout per step:  <dir>/step_<N>/
    manifest.msgpack   — dict(step, keys, extra), packed as ``msgpack.packb``
                         packs it (:mod:`repro_torch.train.minipack`)
    arrays.npz         — one ``.npy`` member per leaf, uncompressed, as
                         ``np.savez`` writes it; keys are ``params/...`` and
                         ``opt/...`` paths, sorted

Writes go to a tmp dir + atomic rename; ``latest`` is re-pointed only
after a complete write, so a crash mid-checkpoint never corrupts the run.
The npz is written one leaf at a time (device → host → file), so host
memory holds one leaf, never the whole state; a leaf on the card crosses
through one pinned host buffer, reused for every leaf and in ``restore``
the same way. A ``bfloat16`` leaf is
stored as the reference's ``ml_dtypes`` array is: two raw bytes an
element under the ``.npy`` descr ``'<V2'``; restore reads any 2-byte void
member back as ``torch.bfloat16``.
"""
from __future__ import annotations

import os
import shutil
import zipfile

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve
from repro_torch.models.sharding import place
from repro_torch.train import minipack

IO_CHUNK = 1 << 26  # bytes per write / read call


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


class _Staging:
    """One pinned host buffer, grown to the largest leaf it carries."""

    def __init__(self):
        self.buf = None

    def take(self, nbytes: int) -> torch.Tensor:
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = None
            self.buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        return self.buf[:nbytes]


def _host(t, staging: _Staging) -> tuple[np.ndarray, str | None]:
    """A leaf as a C-contiguous host array (a card's leaf copied into the
    staging buffer), and the ``.npy`` descr to write for it when numpy's
    own would differ (bfloat16)."""
    if not isinstance(t, torch.Tensor):
        return np.ascontiguousarray(np.asarray(t)), None
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.is_cuda:
        host = staging.take(t.numel() * t.element_size()).view(t.dtype).view(t.shape)
        t = host.copy_(t)
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "<V2"
    return t.numpy(), None


def _write_npy(f, a: np.ndarray, descr: str | None):
    header = np.lib.format.header_data_from_array_1_0(a)
    if descr is not None:
        header["descr"] = descr
    np.lib.format.write_array_header_1_0(f, header)
    raw = memoryview(a.reshape(-1)).cast("B")
    for lo in range(0, len(raw), IO_CHUNK):
        f.write(raw[lo : lo + IO_CHUNK])


def save(ckpt_dir: str, step: int, params, opt_state, extra: dict | None = None,
         keep: int = 3):
    """Atomically write a checkpoint; prune to the newest ``keep``.

    A DTensor leaf is written whole: every rank gathers it
    (``full_tensor``), in the same leaf order, and rank 0 writes; the
    other ranks wait for the write to be published before they return.
    """
    multi = dist.is_initialized() and dist.get_world_size() > 1
    writer = not multi or dist.get_rank() == 0
    flat = _flatten(dict(params=params, opt=opt_state))
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        staging = _Staging()
        with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), mode="w",
                             compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
            for key, leaf in flat.items():
                a, descr = _host(leaf, staging)
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    _write_npy(f, a, descr)
                del a
        manifest = dict(step=step, keys=list(flat), extra=extra or {})
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(minipack.packb(manifest))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        with open(os.path.join(ckpt_dir, ".latest.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(ckpt_dir, ".latest.tmp"), os.path.join(ckpt_dir, "latest"))
        _prune(ckpt_dir, keep)
    else:
        for leaf in flat.values():
            if isinstance(leaf, DTensor):
                leaf.full_tensor()  # this rank's part of the gather
    if multi:
        dist.barrier()


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_")
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    path = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def _read_member(zf: zipfile.ZipFile, name: str, staging: _Staging | None
                 ) -> tuple[np.ndarray, bool]:
    """One ``.npy`` member read into its array (a new one, or a view of the
    staging buffer); ``zipfile`` checks its CRC-32 at the member's end →
    (array, whether it holds bfloat16 bits)."""
    with zf.open(name) as f:
        version = np.lib.format.read_magic(f)
        read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                       (2, 0): np.lib.format.read_array_header_2_0}.get(version)
        if read_header is None:
            raise ValueError(f"{name}: .npy format {version} is not supported")
        shape, fortran, dtype = read_header(f)
        if fortran or dtype.hasobject:
            raise ValueError(f"{name}: only C-ordered plain arrays are supported")
        bf16 = dtype.kind == "V" and dtype.itemsize == 2
        dtype = np.dtype("<i2") if bf16 else dtype
        if staging is None:
            a = np.empty(shape, dtype=dtype)
        else:
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            a = staging.take(nbytes).numpy().view(dtype).reshape(shape)
        buf = memoryview(a.reshape(-1)).cast("B")
        for lo in range(0, len(buf), IO_CHUNK):
            part = buf[lo : lo + IO_CHUNK]
            if f.readinto(part) != len(part):
                raise ValueError(f"{name}: truncated")
        if f.read(1):
            raise ValueError(f"{name}: member size does not match its header")
    return a, bf16


def restore(ckpt_dir: str, step: int | None = None, shardings=None, device="cuda"):
    """Load (params, opt_state, extra), each leaf placed as it is read.

    ``shardings``: optional pair of trees (params, opt state) of ``(mesh,
    placements)`` per leaf; such a leaf is placed on that (possibly
    different-size) mesh with ``distribute_tensor``, the elastic restart's
    reshard, or on a mesh of one device moved to that device. Every rank
    reads the files; each keeps its own shard. Leaves without an entry go
    to ``device``."""
    device = resolve(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = minipack.unpackb(f.read())
    flat = {}
    flat_s = {} if shardings is None else _flatten(dict(params=shardings[0], opt=shardings[1]))
    staging = _Staging() if device.type == "cuda" else None
    with zipfile.ZipFile(os.path.join(d, "arrays.npz")) as zf:
        for k in manifest["keys"]:
            a, bf16 = _read_member(zf, k + ".npy", staging)
            t = torch.from_numpy(a)
            t = t.view(torch.bfloat16) if bf16 else t
            if k in flat_s:
                mesh, placements = flat_s[k]
                # from the staging buffer to the mesh's device, then placed
                flat[k] = place(t.to(torch.device(mesh.device_type)), mesh, placements)
            else:
                flat[k] = t.to(device)
            del a, t
    tree = _unflatten(flat)
    return tree["params"], tree["opt"], manifest["extra"]
