"""K3, the ordered scatter-sub, on the id patterns that stress its design.

``brpc_tpu_torch/csrc/embedding_rows.cu`` cuts the table into tiles (row
ranges by column slices, one block each), groups each tile's occurrences in
shared memory in chunks of at most 2048 (row, position) pairs, applies each
touched row's occurrences in batch order and copies the untouched rows. The
cases here hit each part of that: one row holding every id (more than a
chunk), the shard's padded bucket, every row touched and rows near every
multiple of a power of two touched (both sides of a tile's row boundary,
whatever rows a tile holds), fewer rows than a tile holds and rows that are
not a multiple of a tile's, the overflow path at k = 65536, the scalar path
(dims 1 and 7, a misaligned table), rows cut into two column slices, and k
of 0 and 1. The chunked cases are also launched many times over on the
card.

On the CPU each case holds the plain version to ``np.subtract.at`` bit for
bit. Tests marked ``cuda`` hold the kernel to the plain version on the card
and to ``np.subtract.at`` on the host, bit for bit, and check that the
input table was not written; they skip without a card.
"""

import numpy as np
import pytest
import torch

from brpc_tpu_torch.ops import embedding_rows as er

LR = 0.1  # not a power of two: lr * g rounds
CHUNK = 2048  # (row, position) pairs a block groups at once (kCap)


def _ids_one_row(rng, rows):
    return np.full(4096, rows // 2)


def _ids_padded(rng, rows):
    ids = np.zeros(4096, np.int64)
    ids[:3] = rng.integers(1, rows, 3)
    return ids


def _ids_every_row(rng, rows):
    """Every row once, in a shuffled order, then the first and last rows
    and random rows again: both sides of every boundary between tiles are
    touched, whatever the number of tiles."""
    extra = np.concatenate([[0, rows - 1, 0, rows - 1],
                            rng.integers(0, rows, rows // 2)])
    return np.concatenate([rng.permutation(rows), extra])


def _ids_every_third_row(rng, rows):
    """Touched rows between untouched ones, near every boundary."""
    return rng.permutation(np.arange(0, rows, 3))


def _ids_near_powers_of_two(rng, rows):
    """Every multiple of 4, 8, ..., 4096 below ``rows`` and the rows on
    either side of it, shuffled: a multiple of 2**j appears once for each
    such power it is a multiple of. Both sides of a tile boundary that falls
    on one of these multiples are touched, with untouched rows between."""
    ids = [m + d for j in range(2, 13) for m in range(0, rows, 1 << j)
           for d in (-1, 0, 1) if 0 <= m + d < rows]
    return rng.permutation(ids)


def _ids_zipf(rng, rows, k=2048):
    return (rng.zipf(1.1, k) - 1) % rows


# name: (rows, dim, ids drawn from (rng, rows))
CASES = {
    "one_row_k4096_dim4096": (64, 4096, _ids_one_row),
    "padded_bucket": (512, 256, _ids_padded),
    "every_row_rows1001": (1001, 512, _ids_every_row),
    "every_third_row_rows1001": (1001, 512, _ids_every_third_row),
    "near_powers_of_two_rows4099": (4099, 512, _ids_near_powers_of_two),
    "rows5_fewer_than_a_tile": (5, 4096, lambda rng, rows: rng.integers(
        0, rows, 300)),
    "overflow_k65536_dim8": (64, 8, lambda rng, rows: _ids_zipf(
        rng, rows, 65536)),
    "dim1": (20000, 1, lambda rng, rows: _ids_zipf(rng, rows, 700)),
    "dim7": (3000, 7, lambda rng, rows: _ids_zipf(rng, rows, 700)),
    "dim4096": (2048, 4096, _ids_zipf),
    "dim516_two_slices": (40, 516, lambda rng, rows: _ids_zipf(rng, rows,
                                                               64)),
    "k1": (100, 8, lambda rng, rows: np.array([rows - 1])),
    "k0": (100, 8, lambda rng, rows: np.zeros(0)),
}


# The plain version's own cases (the CPU device client runs it for every
# ApplyGrad): a few rows under thousands of duplicate ids, and values
# planted at seeded places in the grads, and in the table's first row:
# signed zeros and subnormals, then also infinities and NaNs.
SIGNED_ZEROS_SUBNORMALS = np.array([0.0, -0.0, 1e-40, -1e-40, -3e-42, 1e-45],
                                   np.float32)
NON_FINITE = np.concatenate([SIGNED_ZEROS_SUBNORMALS,
                             np.array([np.inf, -np.inf, np.nan, -np.nan],
                                      np.float32)])
PLAIN_CASES = {
    "duplicates_k8192_rows3": (3, 64, lambda rng, rows: rng.integers(
        0, rows, 8192), None),
    "duplicates_k20000_rows2_dim1": (2, 1, lambda rng, rows: rng.integers(
        0, rows, 20000), None),
    "signed_zeros_subnormals": (8, 32, lambda rng, rows: rng.integers(
        0, rows, 2048), SIGNED_ZEROS_SUBNORMALS),
    "non_finite": (8, 32, lambda rng, rows: rng.integers(0, rows, 2048),
                   NON_FINITE),
}


def _case(name):
    if name in PLAIN_CASES:
        rows, dim, make_ids, plants = PLAIN_CASES[name]
        seed = len(CASES) + sorted(PLAIN_CASES).index(name)
    else:
        (rows, dim, make_ids), plants = CASES[name], None
        seed = sorted(CASES).index(name)
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, dim)).astype(np.float32)
    ids = np.asarray(make_ids(rng, rows)).astype(np.int32)
    grads = rng.standard_normal((len(ids), dim)).astype(np.float32)
    if name == "padded_bucket":
        grads[3:] = 0
    if plants is not None:
        table[0, :len(plants)] = plants
        at = rng.random(grads.shape) < 0.3
        grads[at] = rng.choice(plants, int(at.sum()))
    return table, ids, grads


def _subtract_at(table, ids, grads):
    want = table.copy()
    np.subtract.at(want, ids, LR * grads)
    return want


def test_cases_cover_the_design():
    """The patterns reach what they are named for."""
    table, ids, _ = _case("one_row_k4096_dim4096")
    assert np.bincount(ids).max() > CHUNK
    table, ids, _ = _case("overflow_k65536_dim8")
    assert np.bincount(ids).max() > CHUNK and len(ids) == 65536
    # Every row touched, and an odd number of rows: whatever rows a tile
    # holds, both sides of each boundary are touched and the last tile is
    # cut short.
    table, ids, _ = _case("every_row_rows1001")
    assert (np.bincount(ids, minlength=len(table)) > 0).all()
    assert len(table) % 2
    table, ids, _ = _case("near_powers_of_two_rows4099")
    hit = np.bincount(ids, minlength=len(table)) > 0
    for j in range(2, 13):
        m = np.arange(1 << j, len(table) - 1, 1 << j)
        assert hit[m - 1].all() and hit[m].all() and hit[m + 1].all()
    assert not hit.all() and len(table) % 2
    _, ids, grads = _case("padded_bucket")
    assert (ids[3:] == 0).all() and not grads[3:].any()


@pytest.mark.parametrize("name", sorted(CASES) + sorted(PLAIN_CASES))
def test_plain_scatter_sub_equals_subtract_at(name):
    """Bit for bit. Where two NaNs meet (a NaN row less a NaN step) the
    CPU keeps one of their payloads, and which one depends on the order of
    the instruction's operands, which numpy and torch choose apart (the
    loop of row subtractions this version replaced chose as torch does),
    so a NaN is held as a NaN: the non-finite case compares every element
    that ``np.subtract.at`` leaves a number bit for bit and the NaNs by
    place."""
    table, ids, grads = _case(name)
    t = torch.from_numpy(table.copy())
    with np.errstate(invalid="ignore"):
        got = er.scatter_sub(t, torch.from_numpy(ids),
                             torch.from_numpy(grads),
                             torch.tensor(np.float32(LR))).numpy()
        want = _subtract_at(table, ids, grads)
    nan = np.isnan(want)
    assert nan.any() == (name == "non_finite")
    assert np.array_equal(np.isnan(got), nan)
    assert got[~nan].tobytes() == want[~nan].tobytes()
    assert t.numpy().tobytes() == table.tobytes()  # never in place


# -- the kernel on the card --------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _on_card(table, device, offset=0):
    """The table on the card; ``offset`` floats into its allocation, so
    that an odd offset rules out 16-byte accesses."""
    flat = torch.empty(table.size + offset, dtype=torch.float32,
                       device=device)
    t = flat[offset:].view(table.shape)
    t.copy_(torch.from_numpy(table))
    return t


def _check_on_card(table, ids, grads, device, offset=0):
    t = _on_card(table, device, offset)
    i = torch.from_numpy(ids).to(device)
    g = torch.from_numpy(grads).to(device)
    lr = torch.tensor(np.float32(LR), device=device)
    before = er.launches["scatter_sub"]
    got = er.scatter_sub(t, i, g, lr)
    torch.cuda.synchronize()
    assert er.launches["scatter_sub"] == before + 1
    plain = er.scatter_sub_reference(t, i, g, lr)
    assert got.cpu().numpy().tobytes() == plain.cpu().numpy().tobytes()
    assert got.cpu().numpy().tobytes() == \
        _subtract_at(table, ids, grads).tobytes()
    assert t.cpu().numpy().tobytes() == table.tobytes()  # never in place


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_plain_and_subtract_at_on_card(cuda_device, name):
    _check_on_card(*_case(name), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["one_row_k4096_dim4096",
                                  "overflow_k65536_dim8"])
def test_kernel_repeats_bit_equal_on_card(cuda_device, name):
    """The cases that take the chunked path, launched again and again: a
    fault in the block's shared bookkeeping between warps would show as a
    launch that differs (or hangs) now and then."""
    table, ids, grads = _case(name)
    t = _on_card(table, cuda_device)
    i = torch.from_numpy(ids).to(cuda_device)
    g = torch.from_numpy(grads).to(cuda_device)
    lr = torch.tensor(np.float32(LR), device=cuda_device)
    want = _subtract_at(table, ids, grads).tobytes()
    outs = [er.scatter_sub(t, i, g, lr) for _ in range(50)]
    torch.cuda.synchronize()
    for got in outs:
        assert got.cpu().numpy().tobytes() == want
    assert t.cpu().numpy().tobytes() == table.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dim4096", "every_third_row_rows1001"])
def test_kernel_scalar_path_on_a_misaligned_table(cuda_device, name):
    """A table one float into its allocation takes the scalar path at any
    dim; the result is the same bits."""
    _check_on_card(*_case(name), cuda_device, offset=1)
