"""The port's in-plane watershed sweeps against the JAX reference.

``spatial_sweeps_reference`` (the plain PyTorch version of the CUDA kernel)
must be bit-equal to K whole-array XLA sweeps (``tests/test_ws_pallas.py``)
and to K sweeps of the Pallas kernel run in interpret mode, for
connectivity 1-3 and K = 8 and 4, on a ragged (3, 230, 257), and to the
Pallas kernel built at K = 8 on a smaller ragged shape.  The state is
``chip_smoke.sweep_inputs``: a flood part-way through, from seeds on about
1 % of pixels with 24 labels and the -1 barrier competing.
The kernel itself is held against the plain version in
``tests/test_torch_cuda.py``, on the card.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side, and
# torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from chip_smoke import sweep_inputs  # noqa: E402
from test_ws_pallas import xla_spatial_sweep  # noqa: E402
from tobac_flow_tpu.ops import watershed as jws  # noqa: E402
from tobac_flow_tpu.ops.ws_pallas import spatial_sweeps_pallas  # noqa: E402
from tobac_flow_tpu_torch.ops import ws_sweeps  # noqa: E402

META_MAX = np.int32(np.iinfo(np.int32).max)


def _inputs(shape, in_plane, seed=0):
    """field, seeded, floodable and the (claim, claim2, meta) state."""
    claim, claim2, meta, field, seeded, floodable = (
        a.numpy() for a in sweep_inputs(shape, seed, "cpu", in_plane)
    )
    return field, seeded, floodable, (claim, claim2, meta)


def _in_plane(connectivity):
    taps = jws._structure_taps_3d(jws.connectivity_structure(connectivity))
    return tuple((dy, dx) for dt, dy, dx in taps if dt == 0)


def _port(state, field, seeded, floodable, in_plane, k):
    out = ws_sweeps.spatial_sweeps(
        *(torch.from_numpy(a) for a in state), torch.from_numpy(field),
        torch.from_numpy(seeded), torch.from_numpy(floodable), in_plane, k,
    )
    return [o.numpy() for o in out]


def _assert_bit_equal(ref, out):
    for name, a, b in zip(("claim", "claim2", "meta"), ref, out):
        a = np.asarray(a)
        assert a.dtype == b.dtype, name
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        assert same.all(), f"{name}: {(~same).sum()} mismatches"


@pytest.mark.parametrize("k", [8, 4])
@pytest.mark.parametrize("connectivity", [1, 2, 3])
def test_plain_sweeps_bit_equal_to_xla_and_pallas(connectivity, k):
    in_plane = _in_plane(connectivity)
    field, seeded, floodable, state = _inputs((3, 230, 257), in_plane)
    # two chained calls: the second starts from the first one's output
    out = _port(state, field, seeded, floodable, in_plane, k)
    out = _port(out, field, seeded, floodable, in_plane, k)
    fj, sj, flj = jnp.asarray(field), jnp.asarray(seeded), jnp.asarray(floodable)
    ref = tuple(jnp.asarray(a) for a in state)
    for _ in range(2 * k):
        ref = xla_spatial_sweep(ref, fj, sj, flj, in_plane)
    _assert_bit_equal(ref, out)

    # Pallas in interpret mode compiles per K and tap set, ~28 s at K = 8 with
    # 8 taps: its K sweeps run as K/4 calls of 4, the same Jacobi sequence
    pal = tuple(jnp.asarray(a) for a in state)
    for _ in range(2 * k // 4):
        pal = spatial_sweeps_pallas(
            *pal, fj, sj, flj, in_plane, k_sweeps=4, block_rows=64, interpret=True
        )
    _assert_bit_equal(pal, out)


def test_plain_sweeps_bit_equal_to_pallas_k8_build():
    """The Pallas kernel built at K = 8 itself (8-row halo), on a ragged
    shape over two row blocks; ~10 s of interpret-mode compile at 4 taps."""
    in_plane = _in_plane(1)
    field, seeded, floodable, state = _inputs((2, 70, 133), in_plane, seed=2)
    out = _port(state, field, seeded, floodable, in_plane, 8)
    pal = spatial_sweeps_pallas(
        *(jnp.asarray(a) for a in state), jnp.asarray(field), jnp.asarray(seeded),
        jnp.asarray(floodable), in_plane, k_sweeps=8, block_rows=64, interpret=True,
    )
    _assert_bit_equal(pal, out)


def test_sweep_state_is_live():
    """Most pixels of the parity tests' state hold a label, and the sweeps
    change most of them: the compare runs, not the copy of unlabelled
    pixels."""
    in_plane = _in_plane(1)
    field, seeded, floodable, state = _inputs((3, 230, 257), in_plane)
    out = _port(state, field, seeded, floodable, in_plane, 8)
    claim, claim2, meta = state
    assert (meta != META_MAX).mean() > 0.5
    changed = (out[0] != claim) | (out[1] != claim2) | (out[2] != meta)
    assert changed.mean() > 0.4
    assert (meta[seeded] == 1).any()  # -1 barrier seeds compete
    labelled = out[2] != META_MAX
    assert ((out[2][labelled] >> 23) > 0).mean() > 0.1  # hop clocks tick


def test_wrapper_takes_plain_path_on_cpu_and_checks_inputs():
    field, seeded, floodable, state = _inputs((2, 64, 70), _in_plane(1), seed=1)
    args = [torch.from_numpy(a) for a in (*state, field, seeded, floodable)]
    before = ws_sweeps.spatial_sweeps.launches
    out = ws_sweeps.spatial_sweeps(*args, _in_plane(1), 4)
    ref = ws_sweeps.spatial_sweeps_reference(*args, _in_plane(1), 4)
    _assert_bit_equal(ref, [o.numpy() for o in out])
    assert ws_sweeps.spatial_sweeps.launches == before  # no kernel on the CPU
    with pytest.raises(TypeError):
        ws_sweeps.spatial_sweeps(args[0].double(), *args[1:], _in_plane(1), 4)
    with pytest.raises(ValueError):
        ws_sweeps.spatial_sweeps(args[0][:, :10], *args[1:], _in_plane(1), 4)
    with pytest.raises(ValueError):
        ws_sweeps._tap_code(((0, 2),))


@pytest.mark.parametrize("shape", [(1, 1024, 1536), (24, 256, 384), (2, 31, 33)])
def test_launch_plan_covers_each_pixel_once(shape):
    """The plan the wrapper hands the kernel, for every K: shared memory
    within Hopper's per-block limit, the tile interiors covering every
    pixel of every frame exactly once, and no more persistent blocks than
    tiles.  One plan serves every tap set: 4 and 8 taps share the tile."""
    t, h, w = shape
    for k in range(1, 9):
        plan = ws_sweeps.launch_plan(t, h, w, k, 132)
        assert plan.smem_bytes <= ws_sweeps.SMEM_PER_BLOCK
        assert plan.tile == plan.halo - 2 * k and plan.threads == ws_sweeps.THREADS
        assert 1 <= plan.grid <= plan.n_tiles == t * plan.tiles_y * plan.tiles_x
        cover = np.zeros((plan.tiles_y * plan.tile, plan.tiles_x * plan.tile), np.int32)
        for tile in range(plan.tiles_y * plan.tiles_x):  # the kernel's tile order
            by, bx = divmod(tile, plan.tiles_x)
            cover[by * plan.tile:(by + 1) * plan.tile, bx * plan.tile:(bx + 1) * plan.tile] += 1
        assert (cover[:h, :w] == 1).all()
        assert (plan.tiles_y - 1) * plan.tile < h and (plan.tiles_x - 1) * plan.tile < w
    with pytest.raises(ValueError):
        ws_sweeps.launch_plan(t, h, w, 9, 132)


def test_plain_sweeps_nan_and_signed_zero_bit_equal_to_xla():
    """NaN fields and claims, and -0.0 beside +0.0: the plain sweeps follow
    the XLA sweep bit for bit (its max propagates NaN and ranks +0 above
    -0; a NaN claim never compares less or equal)."""
    in_plane = _in_plane(2)
    field, seeded, floodable, state = _inputs((2, 40, 52), in_plane, seed=3)
    rng = np.random.default_rng(3)
    claim, claim2, _ = state
    field[rng.uniform(size=field.shape) < 0.03] = np.nan
    field[rng.uniform(size=field.shape) < 0.1] = -0.0
    claim[rng.uniform(size=claim.shape) < 0.02] = np.nan
    claim[rng.uniform(size=claim.shape) < 0.05] = -0.0
    claim2[rng.uniform(size=claim2.shape) < 0.02] = np.nan
    out = _port(state, field, seeded, floodable, in_plane, 4)
    ref = tuple(jnp.asarray(a) for a in state)
    for _ in range(4):
        ref = xla_spatial_sweep(ref, jnp.asarray(field), jnp.asarray(seeded),
                                jnp.asarray(floodable), in_plane)
    assert np.isnan(out[0]).any() and np.signbit(out[0][out[0] == 0]).any()
    for name, a, b in zip(("claim", "claim2", "meta"), ref, out):
        a = np.asarray(a)
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), name
    specials = np.array([0.0, -0.0, np.nan, 1.0, -np.inf], np.float32)
    a, b = (x.ravel() for x in np.meshgrid(specials, specials))
    ours = ws_sweeps.max_nan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    theirs = np.asarray(jnp.maximum(a, b))
    nan = np.isnan(theirs)
    assert np.array_equal(np.isnan(ours), nan)
    assert np.array_equal(ours[~nan].view(np.int32), theirs[~nan].view(np.int32))
