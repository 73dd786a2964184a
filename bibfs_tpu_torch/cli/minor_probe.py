"""Where the batch-minor level's time goes on one CUDA card.

``python -m bibfs_tpu_torch.cli.minor_probe`` builds G(2^20, 8/2^20) (the
graph of ``chip_smoke.py``) and, at the batch geometry of 256 queries,
prints one JSON line per plane type and state with the level kernel's ms
(median of 25 launches, CUDA events, inputs restored between launches)
on three states: ``mid30`` (``chip_smoke.minor_state``), ``round1``
(every vertex unvisited but the endpoints: every row wants a claim) and
``allvisited`` (no row wants one: only the four plane passes). Beside the
built kernel it times variants of the same source, each built into
``csrc/build/probe/`` and held equal to the built kernel's outputs:
``minblocks3`` / ``minblocks4`` (``__launch_bounds__`` asking for 3 or 4
resident blocks per SM) and ``loads16`` (16 frontier loads in flight per
warp). Last, one line per plane type with the parent transpose of a
batch: ``plane.T.contiguous()`` against ``batch_minor._transpose``. A
card and ``nvcc`` are required.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

VARIANTS = {
    "minblocks3": ("__launch_bounds__(kThreads) minor_level_kernel",
                   "__launch_bounds__(kThreads, 3) minor_level_kernel"),
    "minblocks4": ("__launch_bounds__(kThreads) minor_level_kernel",
                   "__launch_bounds__(kThreads, 4) minor_level_kernel"),
    "loads16": ("constexpr int kLoads = 8;", "constexpr int kLoads = 16;"),
}


def _variant_libs(_cuda) -> dict:
    """Each variant built from an edited copy of ``batch_minor.cu``."""
    out = _cuda.CSRC / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    text = (_cuda.CSRC / "batch_minor.cu").read_text()
    jobs = {}
    for name, (old, new) in VARIANTS.items():
        if old not in text:
            raise RuntimeError(f"variant {name}: the source has no {old!r}")
        src = out / f"{name}.cu"
        src.write_text(text.replace(old, new))
        jobs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
             str(out / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        handle = ctypes.CDLL(str(out / f"lib{name}.so"))
        fn = handle.bibfs_minor_level
        fn.argtypes = _cuda.SIGNATURES["batch_minor"]["bibfs_minor_level"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main(argv=None) -> int:
    if argv:
        print(__doc__.split("\n\n")[0], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("minor_probe: CUDA is not available", file=sys.stderr)
        return 2

    import chip_smoke as cs

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
    g = dense.DeviceGraph.build(n, gnp_random_graph(n, 8 / n, seed=7), device=dev)
    nbr_t = dense._kernel_table(g.tables, g.nbr, g.deg)

    def level(fn, dual, planes, active):
        if fn is None:
            return ml.minor_level(nbr_t, g.deg, dual, *planes, 1, active)
        b = dual.shape[1]
        counts = torch.zeros(3, b, dtype=torch.int32, device=dev)
        key = torch.full((b,), ml.NO_MEET, dtype=torch.int64, device=dev)
        dual_n = torch.empty_like(dual)
        rc = fn(dual.element_size(), nbr_t.data_ptr(), nbr_t.stride(0),
                nbr_t.shape[0], nbr_t.shape[1], g.deg.data_ptr(),
                dual.shape[0], b, dual.data_ptr(), dual_n.data_ptr(),
                *[p.data_ptr() for p in planes], 1, active.data_ptr(),
                counts.data_ptr(), key.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"variant launch failed ({rc})")
        return dual_n, counts, key

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
        states = {
            "mid30": cs.minor_state(g, n_pad2, b, dt8, 21),
            "round1": (dual, [ds, dt, par, par.clone()], ones),
            "allvisited": (dual, [seen, seen.clone(), par.clone(), par.clone()],
                           ones),
        }
        for state, (sdual, base, active) in states.items():
            row = {"plane": "int8" if dt8 else "int32", "state": state}
            ref = None
            for name, fn in launchers.items():
                work = [p.clone() for p in base]
                out = [x.clone() for x in level(fn, sdual, work, active)] + work
                if ref is None:
                    ref = out
                elif not all(torch.equal(x, y) for x, y in zip(out, ref)):
                    raise RuntimeError(f"variant {name} differs on {state}")

                def restore(work=work):
                    for x, y in zip(work, base):
                        x.copy_(y)

                row[name] = cs.time_launch(
                    lambda fn=fn, work=work: level(fn, sdual, work, active),
                    restore)
            print(json.dumps(row), flush=True)
        del states, dual, ds, dt, par, seen, sdual, base
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
