"""The port's collective rings against the JAX package's, on the CPU.

``collective_matmul`` (the tp reduce-scatter ring) and ``allgather_matmul``
(the FSDP all-gather ring) run in one gloo world of 4 processes, spawned
once for the file (``tests/torch_mesh_worker.py``), on meshes tp4,
fsdp2 x tp2, fsdp4 and dp2 x fsdp2, and dp2 x tp2 with its ranks in the
multislice order of two slices given out of order (so a process group's
rank order is not the mesh's); JAX runs its rings on the same meshes over 4
of its 8 CPU devices, in the same order. Each rank's output and the gradients of its
pieces of x and w (loss sum(y * r)) match JAX's and the plain product's
(x @ w, its gradients r @ w^T and x^T @ r) to 1e-5 of their largest
entry: no factor of tp or of the data size. The fp8 and int8 partial
products (each chunk quantized with its own scales) match JAX's quantized
partials to the same limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dstack_tpu.workloads import quantize as jquant
from dstack_tpu.workloads.kernels import collective as jcollective
from dstack_tpu.workloads.sharding import make_mesh as jmake_mesh
from tests.torch_mesh_worker import start_world

TOL = 1e-5
B, T, K, N = 4, 8, 64, 32
MESHES = {
    "tp4": dict(dp=1, fsdp=1, tp=4, sp=1),
    "fsdp2-tp2": dict(dp=1, fsdp=2, tp=2, sp=1),
    "fsdp4": dict(dp=1, fsdp=4, tp=1, sp=1),
    "dp2-fsdp2": dict(dp=2, fsdp=2, tp=1, sp=1),
    # sharding.make_multislice_mesh(2, [1, 0, 1, 0], tp=2)'s order.
    "multislice-dp2-tp2": dict(dp=2, fsdp=1, tp=2, sp=1, ranks=[1, 3, 0, 2]),
}
CASES = [
    ("collective", "tp4", "none"),
    ("collective", "fsdp2-tp2", "none"),
    ("collective", "fsdp2-tp2", "int8"),
    ("collective", "fsdp2-tp2", "fp8"),
    ("allgather", "fsdp4", "none"),
    ("allgather", "dp2-fsdp2", "none"),
    ("allgather", "fsdp2-tp2", "none"),
    ("allgather", "fsdp2-tp2", "int8"),
    ("allgather", "fsdp2-tp2", "fp8"),
    ("collective", "multislice-dp2-tp2", "none"),
    ("allgather", "multislice-dp2-tp2", "none"),
]
IDS = ["-".join(c) for c in CASES]


def operands(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, K).astype(np.float32)
    w = (rng.randn(K, N) / np.sqrt(K)).astype(np.float32)
    r = rng.randn(B, T, N).astype(np.float32)
    return x, w, r


def jax_ring(kind, mesh_name, quant):
    """JAX's ring on the same mesh: y and (dL/dx, dL/dw) of sum(y * r)."""
    x, w, r = operands()
    axes = dict(MESHES[mesh_name])
    order = axes.pop("ranks", range(4))
    mesh = jmake_mesh(**axes, devices=[jax.devices()[i] for i in order])
    mm = {"none": None, "int8": jquant.int8_matmul_ste, "fp8": jquant.fp8_matmul_ste}[quant]
    ring = jcollective.collective_matmul if kind == "collective" else jcollective.allgather_matmul

    def loss(x, w):
        y = ring(x, w, mesh, matmul=mm)
        return jnp.sum(y * r), y

    (_, y), (dx, dw) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(x, w)
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    """Every case on one gloo world of 4 ranks (each rank's results), and
    JAX's, computed while the world runs."""
    x, w, r = operands()
    jobs = [("ring", dict(shape=MESHES[m], kind=kind, quant=q, x=x, w=w, r=r))
            for kind, m, q in CASES]
    port = start_world(jobs, 4, tmp_path_factory.mktemp("rings"))
    jax_out = [jax_ring(*case) for case in CASES]
    return port(), jax_out


def _close(got, want, what):
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0, err_msg=what)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_ring_matches_jax_and_the_plain_product(case, rings):
    port_rings, jax_out = rings
    _, _, quant = CASES[case]
    x, w, r = operands()
    jy, jdx, jdw = jax_out[case]
    plain = (x @ w, r @ w.T, np.einsum("btk,btn->kn", x, r))
    for rank, results in enumerate(port_rings):
        got = results[case]
        xi, wi, yi = got["x_index"], got["w_index"], got["y_index"]
        for name, value, ref, idx in (("y", got["y"], jy, yi), ("dx", got["dx"], jdx, xi),
                                      ("dw", got["dw"], jdw, wi)):
            _close(value, ref[idx], f"rank {rank} {name} against JAX")
        # The quantized rings' gradients are straight-through: the plain
        # product's too.
        checks = zip(("y", "dx", "dw"), (got["y"], got["dx"], got["dw"]), plain, (yi, xi, wi))
        for name, value, ref, idx in checks if quant == "none" else list(checks)[1:]:
            _close(value, ref[idx], f"rank {rank} {name} against the plain product")


def test_the_quantized_partials_are_quantized(rings):
    """The int8 and fp8 cases differ from the fp product (by more than the
    limit): the rings did quantize their chunks."""
    port_rings, _ = rings
    x, w, _ = operands()
    for case, (_, _, quant) in enumerate(CASES):
        if quant == "none":
            continue
        got = port_rings[0][case]
        err = np.max(np.abs(got["y"] - (x @ w)[got["y_index"]]))
        assert err > TOL * np.max(np.abs(x @ w)), (CASES[case], err)
