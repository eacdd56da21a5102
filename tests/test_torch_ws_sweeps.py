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
