"""Where the batch-minor level's time goes on one CUDA card.

``python -m bibfs_tpu_torch.cli.minor_probe`` builds G(2^20, 8/2^20) (the
graph of ``chip_smoke.py``) and, at the batch geometry of 256 queries,
prints one JSON line per plane type and state with the level kernel's ms
(median of 25 launches, CUDA events, inputs restored between launches)
on three states: ``mid30`` (``chip_smoke.minor_state``), ``round1``
(every vertex unvisited but the endpoints: every row wants a claim) and
``allvisited`` (no row wants one: only the row words). Beside the built
kernel it times variants of the same source, each built with other
values of its compile-time knobs (:data:`VARIANTS`: rows per warp tile,
gathers in flight, the register budget as resident blocks per SM) into
``csrc/build/probe/`` and held equal to the built kernel's outputs. Then one line per plane
type with the parent transpose of a batch (``plane.T.contiguous()``
against ``batch_minor._transpose``), and one line per mode that splits a
whole batch of 256 seeded pairs into its level launches, plane fills,
copies (the parent transposes and the clones) and the rest, from
``torch.profiler`` over 5 batches. A card and ``nvcc`` are required.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

VARIANTS = {
    "rows8": ["-DMINOR_ROWS=8"],
    "loads8": ["-DMINOR_LOADS=8"],
    "loads32": ["-DMINOR_LOADS=32"],
    "blocks2": ["-DMINOR_BLOCKS_INT8=2", "-DMINOR_BLOCKS_INT32=2"],
    "blocks_swapped": ["-DMINOR_BLOCKS_INT8=3", "-DMINOR_BLOCKS_INT32=4"],
}
REPEATS = 5


def _variant_libs(_cuda) -> dict:
    """Each variant built from ``batch_minor.cu`` with its ``-D`` flags."""
    out = _cuda.CSRC / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = _cuda.CSRC / "batch_minor.cu"
    jobs = {}
    for name, flags in VARIANTS.items():
        jobs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-I", str(_cuda.CSRC),
             "-o", str(out / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        handle = ctypes.CDLL(str(out / f"lib{name}.so"))
        fn = handle.bibfs_minor_level
        fn.argtypes = _cuda.SIGNATURES["batch_minor"]["bibfs_minor_level"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def _bucket(name: str) -> str:
    if "minor_level_kernel" in name:
        return "level"
    low = name.lower()
    if "fill" in low:
        return "fill"
    if "copy" in low:
        return "copy"
    return "other"


def batch_split(g, pairs, mode: str) -> dict:
    """Device ms per batch by bucket (level launches, plane fills, copies,
    the rest) over :data:`REPEATS` profiled batches, beside the batch's
    median wall ms (``time_batch_graph``)."""
    from bibfs_tpu_torch.cli.profile import _kernel_events
    from bibfs_tpu_torch.solvers import dense

    times, res = dense.time_batch_graph(g, pairs, repeats=REPEATS, mode=mode)
    _p, thunk, _f = dense._batch_dispatch(g, pairs, mode)
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
    ) as prof:
        for _ in range(REPEATS):
            thunk()
        torch.cuda.synchronize()
    ms = {"level": 0.0, "fill": 0.0, "copy": 0.0, "other": 0.0}
    counts = dict.fromkeys(ms, 0)
    for name, us in _kernel_events(prof):
        ms[_bucket(name)] += us / 1e3 / REPEATS
        counts[_bucket(name)] += 1
    return {"split": mode, "batch_ms": float(np.median(times)) * 1e3,
            "device_ms": sum(ms.values()),
            **{f"{k}_ms": v for k, v in ms.items()},
            **{f"{k}_ops": c / REPEATS for k, c in counts.items()},
            "host_reads": res[0].host_syncs}


def main(argv=None) -> int:
    if argv:
        print(__doc__.split("\n\n")[0], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("minor_probe: CUDA is not available", file=sys.stderr)
        return 2

    import chip_smoke as cs

    from bibfs_tpu_torch.graph.csr import build_csr, canonical_pairs
    from bibfs_tpu_torch.graph.generate import gnp_random_graph
    from bibfs_tpu_torch.ops import _cuda
    from bibfs_tpu_torch.ops import minor_level as ml
    from bibfs_tpu_torch.solvers import batch_minor as bmin
    from bibfs_tpu_torch.solvers import dense

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _cuda.build()
    launchers = {"built": None, **_variant_libs(_cuda)}
    n = 1 << 20
    edges = gnp_random_graph(n, 8 / n, seed=7)
    pa = canonical_pairs(n, edges)
    g = dense.DeviceGraph.build(n, edges, device=dev, pairs=pa)
    nbr_t = dense._kernel_table(g.tables, g.nbr, g.deg)

    def level(fn, front, planes, active, key):
        if fn is None:
            return ml.minor_level(nbr_t, g.deg, front, *planes, 1, active, key)
        b = active.shape[0]
        counts = torch.zeros(3, b, dtype=torch.int32, device=dev)
        key_n = key.clone()
        front_n = torch.empty_like(front)
        rc = fn(planes[1].element_size(), nbr_t.data_ptr(), nbr_t.stride(0),
                nbr_t.shape[0], nbr_t.shape[1], g.deg.data_ptr(),
                front.shape[0], b, front.data_ptr(), front_n.data_ptr(),
                *[p.data_ptr() for p in planes], 1, active.data_ptr(),
                counts.data_ptr(), key_n.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"variant launch failed ({rc})")
        return front_n, counts, key_n

    def packed(dual, ds, dt, ps, pt, active):
        return (ml.pack_front(dual), [ml.pack_vis(ds, dt), ds, dt, ps, pt],
                active, ml.meet_vote(ds, dt))

    b = cs.BATCH
    for dt8 in (True, False):
        n_pad2 = bmin._minor_geometry(g, b, dt8)[0]
        pdt = torch.int8 if dt8 else torch.int32
        inf = ml.plane_inf(pdt)
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        qi = torch.arange(b, device=dev)
        srcs = torch.randint(0, n, (b,), generator=gen, device=dev)
        dsts = torch.randint(0, n, (b,), generator=gen, device=dev)
        dual = torch.zeros(n_pad2, b, dtype=pdt, device=dev)
        dual[srcs, qi] = 1
        dual[dsts, qi] = dual[dsts, qi] | 2
        ds = torch.full((n_pad2, b), inf, dtype=pdt, device=dev)
        dt = ds.clone()
        ds[srcs, qi] = 0
        dt[dsts, qi] = 0
        par = torch.full((n_pad2, b), -1, dtype=pdt, device=dev)
        ones = torch.ones(b, dtype=torch.int32, device=dev)
        seen = torch.zeros(n_pad2, b, dtype=pdt, device=dev)
        mid_dual, mid_planes, mid_active = cs.minor_state(g, n_pad2, b, dt8, 21)
        states = {
            "mid30": packed(mid_dual, *mid_planes, mid_active),
            "round1": packed(dual, ds, dt, par, par.clone(), ones),
            "allvisited": packed(dual, seen, seen.clone(), par.clone(),
                                 par.clone(), ones),
        }
        del mid_dual, mid_planes, dual, ds, dt, par, seen
        for state, (front, base, active, key) in states.items():
            row = {"plane": "int8" if dt8 else "int32", "state": state}
            ref = None
            for name, fn in launchers.items():
                work = [p.clone() for p in base]
                out = [x.clone() for x in level(fn, front, work, active, key)]
                out += work
                if ref is None:
                    ref = out
                elif not all(torch.equal(x, y) for x, y in zip(out, ref)):
                    raise RuntimeError(f"variant {name} differs on {state}")

                def restore(work=work):
                    for x, y in zip(work, base):
                        x.copy_(y)

                row[name] = cs.time_launch(
                    lambda fn=fn, work=work: level(fn, front, work, active, key),
                    restore)
                del work, out
            print(json.dumps(row), flush=True)
            del ref
        del states
        torch.cuda.empty_cache()
        plane = torch.randint(-1, 100, (n_pad2, b), dtype=pdt, device=dev)
        if not torch.equal(bmin._transpose(plane), plane.T.contiguous()):
            raise RuntimeError("the two-pass transpose differs")
        print(json.dumps({
            "plane": "int8" if dt8 else "int32", "transpose": list(plane.shape),
            "one_pass_ms": cs.time_launch(lambda: plane.T.contiguous()),
            "two_pass_ms": cs.time_launch(lambda: bmin._transpose(plane)),
        }), flush=True)
        del plane
        torch.cuda.empty_cache()
    csr = build_csr(n, pairs=pa)
    bpairs = cs.batch_pairs(np.random.default_rng(17), n, csr, b)
    for mode in ("minor8", "minor"):
        print(json.dumps(batch_split(g, bpairs, mode)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
