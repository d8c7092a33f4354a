"""Port parity: device meshes and the multi-process tiers
(batchreactor_tpu_torch/parallel: ``mesh=``, ``mesh_resident=``,
``multihost``) against the JAX package, on the CPU.

A mesh that lists the CPU twice splits the lanes over two host threads:
``ensemble_solve``, ``ensemble_solve_segmented``, ``temperature_sweep``
and ``batch_reactor_sweep`` equal their ``mesh=None`` runs bit for bit
(h2o2, B = 8 in two shards of 4) and the JAX package's
``make_mesh()`` runs within 10 rtol.  On the CPU a shard's last bits can
move with its batch shape (the elementwise kernels' vector body and scalar
tail round ``exp``/``pow`` apart), so a ragged split is held to steps
exactly and states within 1e-12.  Two gloo processes run
``ensemble_solve_multihost`` against the JAX package's single-process
solve (10 rtol), then the elastic sweep with one process killed: the
survivor takes its chunks over and returns the single-process sweep.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import batchreactor_tpu as br
import batchreactor_tpu_torch as bt
from batchreactor_tpu import parallel as par_j
from batchreactor_tpu.ops.rhs import make_gas_jac as jac_j
from batchreactor_tpu.ops.rhs import make_gas_rhs as rhs_j
from batchreactor_tpu_torch import parallel as par
from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
from batchreactor_tpu_torch.parallel import checkpoint as ck
from batchreactor_tpu_torch.parallel import sweep as sw

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-6
T1 = 1e-4
B = 8
CPU2 = par.Mesh(["cpu", "cpu"])
H2O2_X = {"H2": 0.3, "O2": 0.15, "N2": 0.55}


def _decay_rhs(t, y, cfg):
    return -cfg["k"][:, None] * y


def _decay(n):
    y0 = torch.tensor([1.0, 0.5], dtype=torch.float64).expand(n, 2).clone()
    return y0, {"k": torch.logspace(1.0, 2.0, n, dtype=torch.float64)}


def _equal(a, b):
    for f in ("t", "y", "status", "n_accepted", "n_rejected", "h"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module")
def h2o2(fixtures_dir):
    path = os.path.join(fixtures_dir, "h2o2.dat")
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    th_j = br.create_thermo(list(gm_j.species), therm)
    gm_t = bt.compile_gaschemistry(path, device="cpu")
    th_t = bt.create_thermo(list(gm_t.species), therm, device="cpu")
    sp = list(gm_t.species)
    X = np.zeros((B, len(sp)))
    for k, v in H2O2_X.items():
        X[:, sp.index(k)] = v
    T = np.linspace(1100.0, 1500.0, B)
    y0_j = par_j.sweep_solution_vectors(jnp.asarray(X), th_j.molwt,
                                        jnp.asarray(T), 1e5)
    rj, jj = rhs_j(gm_j, th_j), jac_j(gm_j, th_j)
    # the JAX package's single-process sweep on its 8-device CPU mesh: the
    # reference of the mesh and the multihost tests
    ref = par_j.ensemble_solve(rj, y0_j, 0.0, T1, {"T": jnp.asarray(T)},
                               jac=jj, linsolve="lu",
                               mesh=par_j.sweep.make_mesh())
    return dict(gm_j=gm_j, th_j=th_j, gm_t=gm_t, th_t=th_t, T=T,
                rhs_t=make_gas_rhs(gm_t, th_t), jac_t=make_gas_jac(gm_t, th_t),
                rhs_j=rj, jac_j=jj, y0_j=y0_j,
                y0_t=bt.get_solution_vector(X, th_t.molwt, torch.tensor(T),
                                            1e5),
                ref_y=np.asarray(ref.y), ref_status=np.asarray(ref.status))


@pytest.mark.parametrize("entry", ["ensemble_solve",
                                   "ensemble_solve_segmented"])
def test_mesh_split_equals_unsplit_and_jax(h2o2, entry):
    fn = getattr(par, entry)
    kw = dict(jac=h2o2["jac_t"], linsolve="lu")
    if entry == "ensemble_solve_segmented":
        kw["segment_steps"] = 64
    cfg = {"T": torch.tensor(h2o2["T"])}
    whole = fn(h2o2["rhs_t"], h2o2["y0_t"], 0.0, T1, cfg, **kw)
    split = fn(h2o2["rhs_t"], h2o2["y0_t"], 0.0, T1, cfg, mesh=CPU2, **kw)
    _equal(whole, split)
    np.testing.assert_array_equal(split.status.numpy(), h2o2["ref_status"])
    np.testing.assert_allclose(split.y.numpy(), h2o2["ref_y"],
                               rtol=10 * RTOL, atol=1e-12)


def test_temperature_sweep_mesh_equals_unsplit_and_jax(h2o2):
    y0 = h2o2["y0_t"][0]
    kw = dict(jac=h2o2["jac_t"], linsolve="lu")
    whole = par.temperature_sweep(h2o2["rhs_t"], y0, h2o2["T"], T1, **kw)
    split = par.temperature_sweep(h2o2["rhs_t"], y0, h2o2["T"], T1,
                                  mesh=CPU2, **kw)
    _equal(whole, split)
    ref = par_j.temperature_sweep(h2o2["rhs_j"], h2o2["y0_j"][0],
                                  jnp.asarray(h2o2["T"]), T1,
                                  jac=h2o2["jac_j"], linsolve="lu",
                                  mesh=par_j.sweep.make_mesh())
    np.testing.assert_array_equal(split.status.numpy(),
                                  np.asarray(ref.status))
    np.testing.assert_allclose(split.y.numpy(), np.asarray(ref.y),
                               rtol=10 * RTOL, atol=1e-12)


def test_api_mesh_equals_unsplit(h2o2):
    kw = dict(chem=bt.Chemistry(gaschem=True), thermo_obj=h2o2["th_t"],
              md=h2o2["gm_t"], device="cpu", ignition_marker="H2",
              segment_steps=64)
    whole = bt.batch_reactor_sweep(H2O2_X, h2o2["T"], 1e5, T1, **kw)
    split = bt.batch_reactor_sweep(H2O2_X, h2o2["T"], 1e5, T1, mesh=CPU2,
                                   **kw)
    for k in whole["x"]:
        np.testing.assert_array_equal(split["x"][k], whole["x"][k], k)
    np.testing.assert_array_equal(split["tau"], whole["tau"])
    assert split["report"] == whole["report"]
    with pytest.raises(ValueError, match="incompatible with mesh"):
        bt.batch_reactor_sweep(H2O2_X, h2o2["T"], 1e5, T1, mesh=CPU2,
                               admission=4, **kw)


def test_ragged_mesh_and_mesh_resident():
    """Seven lanes on two devices pad with a copy of the last lane; the
    streaming driver runs one stream per mesh entry."""
    y0, cfg = _decay(7)
    kw = dict(linsolve="lu", segment_steps=64)
    whole = par.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 0.1, cfg, **kw)
    split = par.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 0.1, cfg,
                                         mesh=CPU2, **kw)
    for f in ("status", "n_accepted", "n_rejected"):
        assert torch.equal(getattr(whole, f), getattr(split, f)), f
    np.testing.assert_allclose(split.y.numpy(), whole.y.numpy(), rtol=1e-12,
                               atol=1e-300)
    sw.reset_stream_counts()
    streamed = par.ensemble_solve_segmented(
        _decay_rhs, y0, 0.0, 0.1, cfg, admission=2, mesh_resident=CPU2,
        **kw)
    for f in ("status", "n_accepted", "n_rejected"):
        assert torch.equal(getattr(whole, f), getattr(streamed, f)), f
    np.testing.assert_allclose(streamed.y.numpy(), whole.y.numpy(),
                               rtol=1e-12, atol=1e-300)
    # two streams of one resident slot each harvest every lane (and the
    # padding copy)
    assert sw.STREAM_COUNTS["harvested_lanes"] == 8
    with pytest.raises(ValueError, match="do not divide"):
        par.ensemble_solve_segmented(_decay_rhs, y0, 0.0, 0.1, cfg,
                                     admission=3, mesh_resident=CPU2, **kw)


def test_mesh_validation():
    y0, cfg = _decay(4)
    with pytest.raises(ValueError, match="axis"):
        par.ensemble_solve(_decay_rhs, y0, 0.0, 0.1, cfg, mesh=CPU2,
                           axis="lanes", linsolve="lu")
    # a CUDA device that does not exist raises: no silent CPU run
    with pytest.raises(RuntimeError, match="does not exist"):
        par.ensemble_solve(_decay_rhs, y0, 0.0, 0.1, cfg,
                           mesh=par.Mesh(["cuda:7"]), linsolve="lu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device (a GPU is present here)")
        par.make_mesh()


def test_forward_mesh_equals_unsplit():
    y0, cfg = _decay(4)
    theta = {"k": torch.tensor([1.0, 2.0], dtype=torch.float64)}

    def rhs_theta(t, y, th, c):
        # theta is (K,) shared, or (B P, K) rows inside the tangent jvp
        rate = th["k"][..., 0] * c["k"] * th["k"][..., 1] / 2.0
        return -rate[:, None] * y

    whole = par.ensemble_solve_forward(rhs_theta, y0, 0.0, 0.05, theta, cfg,
                                       linsolve="lu")
    split = par.ensemble_solve_forward(rhs_theta, y0, 0.0, 0.05, theta, cfg,
                                       mesh=CPU2, linsolve="lu")
    _equal(whole, split)
    assert torch.equal(whole.tangents, split.tangents)


CHILD = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
pid, n, port, lib, ck_dir, T1 = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5],
                                 float(sys.argv[6]))
import batchreactor_tpu_torch as bt
from batchreactor_tpu_torch.ops.rhs import make_gas_jac, make_gas_rhs
from batchreactor_tpu_torch.parallel import multihost as mh
from batchreactor_tpu_torch.resilience import inject

mh.initialize(f"localhost:{port}", num_processes=n, process_id=pid,
              timeout_s=120)
gm = bt.compile_gaschemistry(lib + "/h2o2.dat", device="cpu")
th = bt.create_thermo(list(gm.species), lib + "/therm.dat", device="cpu")
sp = list(gm.species)
B = 8
X = np.zeros((B, len(sp)))
X[:, sp.index("H2")], X[:, sp.index("O2")], X[:, sp.index("N2")] = (
    0.3, 0.15, 0.55)
T = torch.tensor(np.linspace(1100.0, 1500.0, B))
y0 = bt.get_solution_vector(X, th.molwt, T, 1e5)
mesh = mh.global_mesh(device="cpu")
shard = mh.scatter_batch(T, mesh)
res = mh.ensemble_solve_multihost(make_gas_rhs(gm, th), y0, 0.0, T1,
                                  {"T": T}, mesh=mesh,
                                  jac=make_gas_jac(gm, th), linsolve="lu")
mine = mh.ensemble_solve_multihost(make_gas_rhs(gm, th), y0, 0.0, T1,
                                   {"T": T}, gather=False, device="cpu",
                                   jac=make_gas_jac(gm, th), linsolve="lu")
import torch.distributed as dist
dist.destroy_process_group()

def _decay_rhs(t, y, cfg):
    return -cfg["k"][:, None] * y

yd = torch.tensor([1.0, 0.5], dtype=torch.float64).expand(8, 2).clone()
cd = {"k": torch.logspace(1.0, 2.0, 8, dtype=torch.float64)}
if pid == 1:
    inject.arm("kill:chunk=3")   # dies before saving its second chunk
out = mh.elastic_checkpointed_sweep(_decay_rhs, yd, 0.0, 0.1, cd, ck_dir,
                                    process_id=pid, num_processes=n,
                                    chunk_size=2, heartbeat_s=0.2,
                                    linsolve="lu")
print("RESULT " + json.dumps({
    "mesh": [str(d) for d in mesh.devices], "shard": shard.tolist(),
    "y": res.y.tolist(), "status": res.status.tolist(),
    "mine_y": mine.y.tolist(), "counts": mh.COUNTS,
    "elastic_y": out.y.tolist(), "elastic_status": out.status.tolist()}))
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_processes_multihost_and_elastic(tmp_path, h2o2, fixtures_dir):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    ck_dir = tmp_path / "elastic"
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", str(port), fixtures_dir,
         str(ck_dir), repr(T1)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert procs[1].returncode == 137, outs[1][-3000:]
    assert procs[0].returncode == 0, outs[0][-3000:]
    got = json.loads(next(ln for ln in outs[0].splitlines()
                          if ln.startswith("RESULT "))[7:])
    assert got["mesh"] == ["cpu", "cpu"]
    np.testing.assert_array_equal(got["shard"], h2o2["T"][:4])
    np.testing.assert_array_equal(got["status"], h2o2["ref_status"])
    np.testing.assert_allclose(got["y"], h2o2["ref_y"], rtol=10 * RTOL,
                               atol=1e-12)
    # rank 0's own lanes, ungathered, are the gathered result's first half
    np.testing.assert_array_equal(got["mine_y"], got["y"][:4])
    # the elastic survivor took the dead process's chunk over and returns
    # a fresh single-process checkpointed sweep, bit for bit; the
    # directory resumes in one process (the same fingerprint)
    assert got["counts"]["chunks_reassigned"] >= 1
    assert sorted(p.name for p in ck_dir.glob("chunk_*.npz")) == [
        f"chunk_{i:05d}.npz" for i in range(4)]
    y0, cfg = _decay(8)
    single = ck.checkpointed_sweep(_decay_rhs, y0, 0.0, 0.1, cfg,
                                   str(tmp_path / "single"), chunk_size=2,
                                   linsolve="lu")
    ck.reset_counts()
    ck.checkpointed_sweep(_decay_rhs, y0, 0.0, 0.1, cfg, str(ck_dir),
                          chunk_size=2, linsolve="lu")
    assert ck.COUNTS["chunks_solved"] == 0
    np.testing.assert_array_equal(got["elastic_y"], single.y.numpy())
    np.testing.assert_array_equal(got["elastic_status"],
                                  single.status.numpy())
