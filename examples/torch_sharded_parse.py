"""Mesh-native distributed parsing with the PyTorch port: ``ParserConfig(mesh="host")``.

    PYTHONPATH=src python examples/torch_sharded_parse.py [--smoke] [--ranks 2]
        [--device cuda|cpu] [--backend cuda|torch|packed|sparse] [--kernel]

Spawns ``--ranks`` processes (``torch.multiprocessing``, a file rendezvous)
that form one ``torch.distributed`` group: over NCCL with one rank a card
where there are enough cards, else over gloo (ranks sharing one card, or the
CPU).  Distribution is DECLARATIVE on the public API — ``mesh="host"``
selects a ('pod', 'data') mesh over every rank, PaREM-style chunk splitting
over it:

  1. chunk-sharded parse  — ONE long text, chunk dim split over every
     'chunk' mesh axis; reach/build&merge run shard-local, one all-gather of
     the product stack feeds the replicated join;
  2. sharded-batched parse — batch slots shard over 'data' while chunks keep
     'pod', one program serves many texts across the mesh;
  3. sharded streaming     — a facade stream on the mesh engine ships its
     sealed-product stack as the all-gather payload.

Every output is bit-identical to the single-process parser, on every rank.
Rank 0's lines are printed, then each rank's kernel launches.  A rank that
fails ends the run (the others are killed), as does one still running after
``--timeout`` seconds; the exit code is then 1.

``--device cuda`` (the default) runs on the card(s) and fails when there is
none; ``--device cpu`` runs ``torch`` (or ``packed`` / ``sparse`` without
``--kernel``) on the CPU.
"""

import argparse
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parents[1] / "src"))

import numpy as np

import repro_torch
from repro_torch.core.engine import resolve_device


def sharded(backend: str, kernel: bool, device) -> tuple:
    """This rank's run of the three parts: its lines and whether every
    output equalled the single-process parser's."""
    pattern = "(a|b|ab)+"
    ref = repro_torch.Parser(repro_torch.ParserConfig(
        regex=pattern, backend=backend, kernel=kernel), device=device)
    eng = repro_torch.Parser(repro_torch.ParserConfig(
        regex=pattern, backend=backend, kernel=kernel, mesh="host"), device=device)
    d = eng.engine.dist
    lines = [f"RE {pattern!r} on mesh {dict(eng.engine.mesh.shape)}",
             f"  chunk axes {d.chunk_axes} (single text) | "
             f"batch over {d.batch_axes} x chunks over {d.batch_chunk_axes}"]
    same_all = True

    # 1. one long text, chunks over the whole mesh
    long_text = "ab" * 4000
    s = eng.parse(long_text)
    same = np.array_equal(s.forest.pack(), ref.parse(long_text).forest.pack())
    same_all &= same
    lines.append(f"single long text n={len(long_text)}: ok={s.ok} "
                 f"trees(log2)~{s.count_trees().bit_length()} "
                 f"bit-identical={same}")

    # 2. mixed-length batch, batch x chunk sharding
    texts = ["ab", "", "abab", "ba" * 3, "a" * 23, "ab" * 40, "x", "aabb" * 5]
    got = eng.parse_batch(texts)
    base = ref.parse_batch(texts)
    same = all(
        np.array_equal(g.forest.pack(), b.forest.pack())
        for g, b in zip(got, base)
    )
    same_all &= same
    lines.append(f"batch of {len(texts)} mixed-length texts: "
                 f"ok={[g.ok for g in got]} bit-identical={same}")

    # 3. sharded streaming: sealed products are the all-gather payload
    with eng.open_stream() as stream:
        prefix = ""
        for piece in ["ab", "abab", "ba", "ab" * 10]:
            stream.append(piece)
            prefix += piece
            res = stream.result()
            cold = ref.parse(prefix)
            same = np.array_equal(res.forest.pack(), cold.forest.pack())
            same_all &= same
            lines.append(f"  +{piece!r:12} n={res.forest.n:3d} ok={res.ok!s:5} "
                         f"bit-identical={same}")
    return lines, bool(same_all)


def rank_main(rank: int, world: int, tmp: str, opts: dict) -> None:
    """One rank: joins the group (rendezvous through a file in ``tmp``),
    runs ``sharded`` and writes its report (or its traceback) to ``tmp``;
    exits 1 on a failure."""
    import torch
    import torch.distributed as dist

    report = {"rank": rank, "ok": False}
    try:
        if opts["device"] == "cuda":
            nccl = torch.cuda.device_count() >= world
            device = torch.device("cuda", rank if nccl else 0)
            torch.cuda.set_device(device)
            group_backend = "nccl" if nccl else "gloo"
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        else:
            # one thread a rank: the parts are small, and with the cores' share
            # each rank ran 3.7x slower beside eight busy processes (8 cores)
            device, group_backend = torch.device("cpu"), "gloo"
            torch.set_num_threads(1)
        dist.init_process_group(group_backend, init_method=f"file://{tmp}/store",
                                rank=rank, world_size=world)
        from repro_torch.kernels import ops

        ops.reset_launches()
        lines, same = sharded(opts["backend"], opts["kernel"], device)
        report.update(lines=lines, group=group_backend, bit_identical=same,
                      launches={k: v for k, v in ops.launch_counts().items() if v})
        report["ok"] = same
        if not same:
            report["error"] = "an output differs from the single-process parser's"
    except Exception:
        report["error"] = traceback.format_exc()[-4000:]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(report))
    if not report["ok"]:
        sys.exit(1)


def run_ranks(world: int, opts: dict, timeout_s: float) -> list:
    """``rank_main`` in ``world`` spawned processes; returns their reports
    in rank order and the failures (a rank that failed, or one killed
    because another failed or the time ran out)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="torch_sharded_parse_") as tmp:
        procs = [ctx.Process(target=rank_main, args=(r, world, tmp, opts))
                 for r in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout_s
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
        killed = [r for r, p in enumerate(procs) if p.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join()
        reports, failures = [], []
        for r, proc in enumerate(procs):
            path = Path(tmp) / f"rank{r}.json"
            rep = json.loads(path.read_text()) if path.exists() else {}
            reports.append(rep)
            if r in killed:
                failures.append(f"rank {r} killed (timeout {timeout_s} s, or another rank failed)")
            elif proc.exitcode != 0 or not rep.get("ok"):
                failures.append(f"rank {r} exit code {proc.exitcode}: "
                                f"{rep.get('error', 'no report')}")
    return reports, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny CI run (default sizes already are)")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before the ranks still running are killed")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=repro_torch.list_backends(),
                    help="default: cuda on the card, torch on the CPU")
    ap.add_argument("--kernel", action="store_true",
                    help="packed / sparse through their kernels (the card only)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_sharded_parse: {e}", file=sys.stderr)
        return 1
    if device.type == "cuda":
        from repro_torch.kernels import ops

        ops.build()          # once, before the ranks start: they only load it
    opts = {"device": device.type, "kernel": args.kernel,
            "backend": args.backend or ("cuda" if device.type == "cuda" else "torch")}
    reports, failures = run_ranks(args.ranks, opts, args.timeout)
    if failures:
        print("torch_sharded_parse: " + "\n".join(failures), file=sys.stderr)
        return 1
    print(f"{args.ranks} ranks over {reports[0]['group']}, "
          f"every rank bit-identical to the single-process parser")
    for line in reports[0]["lines"]:
        print(line)
    for rep in reports:
        print(f"rank {rep['rank']} kernel launches: {json.dumps(rep['launches'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
