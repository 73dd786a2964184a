"""The PyTorch port and chip_smoke.py import neither JAX nor the JAX
package: checked in a fresh interpreter and by an AST scan."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "bibfs_tpu_torch"


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "bibfs_tpu")


def test_fresh_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import bibfs_tpu_torch\n"
        "for m in pkgutil.walk_packages(bibfs_tpu_torch.__path__, 'bibfs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'bibfs_tpu')]\n"
        "mods = [m for m in sys.modules if m.startswith('bibfs_tpu_torch.')]\n"
        "print(len(mods), bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr
    count = int(out.stdout.split()[0])
    assert count >= len(list(PORT.rglob("*.py"))) - 1  # every module loaded


def test_ast_scan_finds_no_jax_import():
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_chip_smoke_alone_fails_without_output(tmp_path):
    """Copied into a directory with nothing else of the repository,
    chip_smoke.py exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env={"PATH": "/usr/bin:/bin"},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_without_cuda_fails_without_output():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
             "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_spawned_ranks_load_no_jax():
    """The spawned ranks of the sharded search and of the data-parallel
    batch (``parallel.mesh.launch``) import neither JAX nor the JAX
    package, after a solve in every mode and a batch."""
    code = (
        "import json\n"
        "import numpy as np\n"
        "from bibfs_tpu_torch.parallel.mesh import launch\n"
        "from bibfs_tpu_torch.solvers import sharded as sh\n"
        "e = np.array([[i, i + 1] for i in range(39)])\n"
        "jobs = [dict(kind='solve', graph='g', src=0, dst=39, mode=m)\n"
        "        for m in sh.SHARDED_MODES]\n"
        "jobs.append(dict(kind='dp', graph='g', pairs=[(0, 39)], dt8=True))\n"
        "out = launch(sh.sharded_jobs, 2, {'g': sh.build_host_graph(40, e, 2)},\n"
        "             jobs, device='cpu', timeout_s=120)\n"
        "assert all(r.hops == 39 for r in out['results'][:-1])\n"
        "print(json.dumps(out['ranks']))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=180, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr
    import json

    ranks = json.loads(out.stdout.strip().splitlines()[-1])
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["transport"] == "gloo"
        assert "torch" in r["modules"] and "bibfs_tpu_torch" in r["modules"]
        bad = [m for m in r["modules"] if _forbidden(m)]
        assert not bad, (r["rank"], bad)


def test_pool_ranks_load_no_jax():
    """The ranks of a persistent pool (``parallel.pool.MeshPool``) import
    neither JAX nor the JAX package after the mesh route's jobs (the 1D
    batch, the data-parallel batch), the 2D search and checkpointed
    searches on both meshes."""
    code = (
        "import json, os, tempfile\n"
        "import numpy as np\n"
        "from bibfs_tpu_torch.parallel.pool import MeshPool\n"
        "from bibfs_tpu_torch.solvers import sharded as sh\n"
        "from bibfs_tpu_torch.solvers.sharded2d import Sharded2DHost\n"
        "e = np.array([[i, i + 1] for i in range(39)])\n"
        "with MeshPool(2, 'cpu', timeout_s=120) as pool:\n"
        "    d = os.path.join(pool.workdir, 'g')\n"
        "    pool.graph('g', sh.save_host_graph(sh.build_host_graph(40, e, 2), d))\n"
        "    pool.graph('b', Sharded2DHost.build(40, e, 1, 2).save(d + 'b'))\n"
        "    ck = os.path.join(pool.workdir, 'c.ckpt')\n"
        "    jobs = [dict(kind='batch', graph='g', pairs=[(0, 39)], mode='fused'),\n"
        "            dict(kind='dp', graph='g', pairs=[(0, 39)], dt8=True),\n"
        "            dict(kind='solve2d', graph='b', src=0, dst=39),\n"
        "            dict(kind='checkpoint', graph='g', src=0, dst=39, path=ck,\n"
        "                 mode='pallas', chunk=2, max_chunks=1),\n"
        "            dict(kind='resume', graph='b', substrate='2d', src=0,\n"
        "                 dst=39, path=ck)]\n"
        "    out = pool.call('jobs', jobs)['results']\n"
        "    assert out[0][0].hops == out[1][0].hops == out[2].hops == 39\n"
        "    assert out[3] is None and out[4].hops == 39\n"
        "    print(json.dumps(pool.call('hello')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=180, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr
    import json

    hello = json.loads(out.stdout.strip().splitlines()[-1])
    assert hello["transport"] == "gloo"
    assert "torch" in hello["modules"] and "bibfs_tpu_torch" in hello["modules"]
    bad = [m for m in hello["modules"] if _forbidden(m)]
    assert not bad, bad
