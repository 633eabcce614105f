"""Chunk serialization: save and load the whole parameter set (counterpart
of libllsm2_tpu/utils/serialize.py).

Chunks are flat npz archives with the conf stored as JSON, and coder
vectors compact quantized archives; the files are the JAX package's,
byte for byte in layout, so an archive written by either package loads in
the other.  Loaded chunks go to the card unless the caller passes
device="cpu".

The sharded checkpoints (chunk_save_orbax / chunk_load_orbax, named after
the JAX package's counterparts so a reader finds them) are
torch.distributed.checkpoint directories, not orbax ones: the card's
machine has no orbax, so the JAX package's orbax directories do not load
in the port, nor the port's in JAX.  The npz archives cross both ways.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..config import ChunkConf
from ..container import Chunk

_ARRAY_FIELDS = ["f0", "ampl", "phse", "hm_mask", "psd", "edc",
                 "eenv_a", "eenv_p", "rd", "vtmagn", "vsphse"]


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _conf(d: dict) -> ChunkConf:
    d = dict(d, chanfreq=tuple(d["chanfreq"]))
    return ChunkConf(**d)


def chunk_save(path: str, chunk: Chunk) -> None:
    """Save a chunk (and its self-describing conf) to an npz file."""
    arrays = {}
    for name in _ARRAY_FIELDS:
        v = getattr(chunk, name)
        if v is not None:
            arrays[name] = _numpy(v)
    for k, v in (chunk.extras or {}).items():
        arrays["extra_" + k] = _numpy(v)
    conf_json = json.dumps(dataclasses.asdict(chunk.conf))
    np.savez(path, __conf__=np.frombuffer(conf_json.encode(), np.uint8),
             **arrays)


def chunk_load(path: str, device=None) -> Chunk:
    """Load a chunk saved by chunk_save onto `device` (default the card;
    no fallback)."""
    device = "cuda" if device is None else device
    z = np.load(path)
    conf = _conf(json.loads(bytes(z["__conf__"]).decode()))
    put = lambda n: torch.as_tensor(z[n], device=device)
    kw = {name: put(name) if name in z.files else None
          for name in _ARRAY_FIELDS}
    extras = {n[len("extra_"):]: put(n) for n in z.files
              if n.startswith("extra_")}
    return Chunk(conf=conf, extras=extras or None, **kw)


def chunk_save_orbax(path: str, chunk: Chunk, mesh=None) -> None:
    """Sharded checkpoint of a chunk (no batch axis) in a
    torch.distributed.checkpoint directory at `path` (the counterpart of
    the JAX package's orbax checkpoint; the formats do not cross).

    Every rank of the world calls it with the same chunk (SPMD).  With a
    mesh whose frame axis has S > 1 ranks, each rank writes its block of
    N / S frame rows of every field (ranks that hold the same block write
    it once); without one, the whole chunk is written once.  The conf
    rides along as JSON."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    from ..parallel.mesh import FRAME_AXIS

    n, i = 1, 0
    if mesh is not None and FRAME_AXIS in mesh.shape:
        n, i = mesh.shape[FRAME_AXIS], mesh.index(FRAME_AXIS)
    N = chunk.nfrm
    if N % n:
        raise ValueError(f"{N} frames do not split over {n} shards")
    r0, nl = i * (N // n), N // n
    state = {"__conf__": json.dumps(dataclasses.asdict(chunk.conf))}
    for name in _ARRAY_FIELDS:
        v = getattr(chunk, name)
        if v is not None:
            # the frame axis is the chunk's first: rows r0 .. r0 + nl
            state[f"{name}/{r0}"] = v[r0:r0 + nl].detach().cpu().contiguous()
    dcp.save(state, checkpoint_id=path, no_dist=not dist.is_initialized())


def chunk_load_orbax(path: str, device=None) -> Chunk:
    """Load a chunk_save_orbax directory in one process (whatever the
    world it was written by) onto `device` (default the card)."""
    import torch.distributed.checkpoint as dcp

    device = "cuda" if device is None else device
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    state = {"__conf__": ""}
    for key, m in meta.items():
        if key != "__conf__":
            state[key] = torch.empty(tuple(m.size), dtype=m.properties.dtype)
    dcp.load(state, checkpoint_id=path, no_dist=True)
    conf = _conf(json.loads(state.pop("__conf__")))
    parts = {}
    for key, v in state.items():
        name, r0 = key.rsplit("/", 1)
        parts.setdefault(name, []).append((int(r0), v))
    kw = {name: (torch.cat([v for _, v in sorted(parts[name],
                                                 key=lambda p: p[0])])
                 .to(device) if name in parts else None)
          for name in _ARRAY_FIELDS}
    return Chunk(conf=conf, **kw)


def _f0_step16(q, s: int) -> float:
    return max(float(q.hi[s] - q.lo[s]), 1e-12) / 65535.0


def coded_save(path: str, cc, vectors, bits: int = 8,
               quant=None) -> None:
    """Save coder vectors as a compact quantized archive.

    cc: models.coder.CoderConfig; vectors: [..., N, cc.dims] float
    encodes (numpy or a tensor).  bits: 8 (4x smaller than float32) or 16
    (near-lossless).  Pass a prefitted models.coder.Quantizer to share one
    codebook across files (per-file ranges make files non-interchangeable).
    At bits=8 the F0 slot also rides a 16-bit side array (+2 bytes a
    frame): decode re-propagates phases from F0, so the 8-bit F0 step
    decorrelates the render within ~20 frames while every parametric
    metric stays clean."""
    from ..models import coder as coder_mod

    v = np.asarray(_numpy(vectors), np.float32)
    q = quant or coder_mod.fit_quantizer(
        v, bits=bits, dpcm=coder_mod.default_dpcm_mask(cc),
        f0_slot=coder_mod.f0_slot(cc))
    codes = coder_mod.quantize(q, v)
    meta = {"conf": dataclasses.asdict(cc.conf), "nvt": cc.nvt,
            "npsd_c": cc.npsd_c, "with_phase": cc.with_phase,
            "bits": q.bits,
            "f0_slot": None if q.f0_slot is None else int(q.f0_slot)}
    extra = {}
    if q.dpcm is not None:
        extra = {"dpcm": np.asarray(q.dpcm), "dlo": np.asarray(q.dlo),
                 "dhi": np.asarray(q.dhi)}
    if q.bits <= 8 and q.f0_slot is not None:
        s = int(q.f0_slot)
        extra["f016"] = np.round(
            (np.clip(v[..., s], q.lo[s], q.hi[s]) - q.lo[s])
            / _f0_step16(q, s)).astype(np.uint16)
    np.savez(path, __coded__=np.frombuffer(json.dumps(meta).encode(),
                                           np.uint8),
             codes=codes, lo=np.asarray(q.lo), hi=np.asarray(q.hi),
             **extra)


def coded_load(path: str):
    """Load a coded_save archive -> (CoderConfig, float32 numpy vectors),
    which models.coder.decode / decode_frames take directly."""
    from ..models import coder as coder_mod

    z = np.load(path)
    meta = json.loads(bytes(z["__coded__"]).decode())
    cc = coder_mod.CoderConfig(conf=_conf(meta["conf"]), nvt=meta["nvt"],
                               npsd_c=meta["npsd_c"],
                               with_phase=meta["with_phase"])
    q = coder_mod.Quantizer(
        lo=z["lo"], hi=z["hi"], bits=meta["bits"],
        dpcm=z["dpcm"] if "dpcm" in z.files else None,
        dlo=z["dlo"] if "dlo" in z.files else None,
        dhi=z["dhi"] if "dhi" in z.files else None,
        f0_slot=meta.get("f0_slot"))
    v = coder_mod.dequantize(q, z["codes"])
    if "f016" in z.files and q.f0_slot is not None:
        s = int(q.f0_slot)
        v[..., s] = q.lo[s] + z["f016"].astype(np.float32) * _f0_step16(q, s)
    return cc, v
