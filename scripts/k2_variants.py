#!/usr/bin/env python3
"""Time K2's walk kernel in the variants its plan chooses between, on one
NVIDIA GPU, at chip_smoke.py's TRAFFIC (8 MiB) and e125 (1 MiB) shapes.

    python3 scripts/k2_variants.py [--lanes 2,4,8] [--rounds 128,64,32]

The source is built for one lane count (``WALK_LANES`` in
``csrc/build_merge.cu``, ``build.LANES``); for each count asked for, a copy of
the source with that count is compiled into the build directory and loaded
beside the package's own.  Every (lanes, round, both tables or one) variant
whose shared memory fits the plan's warps a block is then launched through
``kernels/build.launch`` with the plan forced, checked bit for bit against
the plain version and timed with ``chip_smoke.device_ms``.  Prints one JSON
line per variant.  The entries are the ``torch`` backend's join of the
texts' chunk products, as chip_smoke.py's K2 record has them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

import chip_smoke as cs  # noqa: E402


def variant_libs(lane_counts):
    """{lanes: ctypes library} of build_merge.cu built for each lane count."""
    from repro_torch.kernels import build, ops

    source = (ops.CSRC / "build_merge.cu").read_text()
    line = f"constexpr int WALK_LANES = {build.LANES};"
    if line not in source:
        raise RuntimeError(f"build_merge.cu has no line {line!r}")
    ops.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = ops._nvcc()
    procs = {}
    for L in lane_counts:
        src = ops.BUILD_DIR / f"build_merge_lanes{L}.cu"
        src.write_text(source.replace(line, f"constexpr int WALK_LANES = {L};"))
        out = src.with_suffix(".so")
        procs[L] = (subprocess.Popen([nvcc, *ops.NVCC_FLAGS, "-o", str(out), str(src)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out)
    libs = {}
    for L, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {L} lanes:\n{log.decode(errors='replace')}")
        lib = ctypes.CDLL(str(out))
        for fn, (restype, argtypes) in build.SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[L] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", default="2,4,8")
    ap.add_argument("--rounds", default="128,64,32")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import Parser, ParserConfig
    from repro_torch.core.backend import TorchBackend
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.checks import MAX_SMEM_BYTES

    dev = torch.device("cuda")
    libs = variant_libs([int(x) for x in args.lanes.split(",")])
    rounds = [int(x) for x in args.rounds.split(",")]
    print(json.dumps({"part": "env", "nvidia_smi": cs.nvidia_smi_line(),
                      "torch": torch.__version__}), flush=True)
    plan = build.plan
    for label, regex, text in (("traffic", cs.TRAFFIC_RE, cs.traffic_log(cs.TRAFFIC_BYTES, 0)),
                               ("e125", cs.E125_RE, cs.e125_text(cs.E125_BYTES, 1))):
        parser = Parser(ParserConfig(regex=regex, backend="torch", n_chunks=cs.N_CHUNKS),
                        device=dev)
        eng = parser.engine
        t = eng.tables
        classes = eng.classes_of_text(text)
        c, k = eng.bucket_shape(len(classes), parser.config.n_chunks)
        ids = eng.chunks_tensor(eng._pad_to(classes, c, k))
        Jf, Jb = TorchBackend().join(ops.reach_chunk_product(t.N, ids), t.I, t.F)
        kargs = (t.N, ids, Jf, Jb)
        want = ops.build_merge_packed.plain(*kargs)
        A1, lp = t.N.shape[0], t.ell_pad
        own = plan(A1, lp, c)
        for L, lib in libs.items():
            units = -(-c // (32 // L))                    # as build.walk_warps counts them
            warps = min(max(-(-units // build.SMS), 1), 32)
            for rs in rounds:
                for both in (True, False):
                    need = ((2 if both else 1) * build.table_bytes(A1, lp, own.g, L)
                            + warps * build.ring_bytes(lp, L, rs))
                    if need > MAX_SMEM_BYTES:
                        continue
                    p = own._replace(lanes=L, round=rs, both=both,
                                     cls_stride=build.class_stride(lp, own.g, L))
                    build.plan = lambda *a, p=p: p
                    try:
                        got = build.launch(lib, *kargs)
                        torch.cuda.synchronize()
                        equal = torch.equal(got, want)
                        ms = cs.device_ms(lambda: build.launch(lib, *kargs))
                    finally:
                        build.plan = plan
                    print(json.dumps({"part": "k2_variant", "text": label, "chunks": c, "k": k,
                                      "lanes": L, "round": rs, "both": both,
                                      "plans_choice": (L, rs, both) == own[2:5],
                                      "equal_plain": equal, "device_ms": ms}), flush=True)
        del kargs, ids, Jf, Jb, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
