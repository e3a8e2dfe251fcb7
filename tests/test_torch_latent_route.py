"""The latent decode's block plan on the CPU (``kernels/latent_decode_attention``,
the mirror of ``csrc/latent_decode_attention.cu``): the mirror against the
source's constants and formulas, and the plan's properties. A row's items
depend on its length alone; every (head, column) of a live row is combined
once, over the row's partials in span order; no item lies past the length;
no block waits on work that no resident block will do; the grid is at most
one wave. The kernel itself runs only on the card (``tests/test_torch_gpu.py``)."""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import latent_decode_attention as LA  # noqa: E402

SRC = (build.CSRC / "latent_decode_attention.cu").read_text()
PH = LA.DV // 4                       # 4-column pieces a head
LENGTHS = [0, 1, 15, 63, 64, 65, 128, 300, 577, 1024, 1056, 2047, 2048, 2049, 4096, 4097,
           9000]


def _const(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, f"{name} not found in latent_decode_attention.cu"
    return int(m.group(1))


def test_mirror_constants_are_the_sources():
    assert (LA.DK, LA.DV, LA.MAX_H) == (_const("DK"), _const("DV"), _const("HMAX"))
    assert (LA.CHUNK, LA.NSMAX, LA.TILE) == (_const("CHUNK"), _const("NSMAX"), _const("HT"))


def test_mirror_formulas_are_the_sources():
    """The source's plan functions and item order, as the mirror reads them."""
    flat = re.sub(r"\s+", " ", SRC)
    for body in ("return (int)((positions + CHUNK - 1) / CHUNK);",
                 "return n_chunks(L) > NSMAX ? (n_chunks(L) + NSMAX - 1) / NSMAX : 1;",
                 "return L < 1 ? 1 : (n_chunks(L) + span_chunks(L) - 1) / span_chunks(L);",
                 "return n_chunks(positions) < 1 ? 1 : n_chunks(positions) < NSMAX ? "
                 "n_chunks(positions) : NSMAX;",
                 "const int pc0 = s * nh * PH / ns, pc1 = (s + 1) * nh * PH / ns;",
                 "const int p0 = s * cps * CHUNK, p_end = min(p0 + cps * CHUNK, L);",
                 "const int grid = (int)(n_items < wave ? n_items : wave);",
                 "const int n_slot = exact ? n_spans((int)positions) : span_slots(positions);"):
        assert body in flat, body
    walk = "const int b = i / (n_slot * n_t), s = i / n_t % n_slot, t = i % n_t;"
    assert flat.count(walk) == 2          # the products' walk, then the combines'


@pytest.mark.parametrize("r0", range(0, 64, 8))
def test_staged_rows_are_free_of_bank_conflicts(r0):
    """Rows lie in pairs (``row_at``): the 8 rows an ldmatrix reads at one
    column start in 8 distinct 16-byte bank groups of the 128 bytes a
    shared-memory wavefront serves."""
    flat = re.sub(r"\s+", " ", SRC)
    assert "constexpr int PAIR = 2 * ROWB + 16;" in flat
    assert "return (r >> 1) * PAIR + (r & 1) * ROWB;" in flat
    rowb = 2 * LA.DK
    pair = 2 * rowb + 16

    def row_at(r):
        return (r >> 1) * pair + (r & 1) * rowb
    assert pair % 16 == 0 and rowb % 16 == 0             # bulk copies land on 16 bytes
    assert len({row_at(r) // 16 % 8 for r in range(r0, r0 + 8)}) == 8


@pytest.mark.parametrize("L", LENGTHS)
def test_spans_cover_the_length_once_in_whole_chunks(L):
    items = [it for it in LA.row_plan(L, 40) if it["t"] == 0]
    assert len(items) == LA.n_spans(L) <= LA.NSMAX
    if L == 0:
        assert items == [{"s": 0, "t": 0, "j0": 0, "j1": 0, "direct": True, "slice": None}]
        return
    pos = 0
    for s, it in enumerate(items):
        assert it["s"] == s and it["j0"] == pos and it["j0"] % LA.CHUNK == 0
        assert 0 < it["j1"] - it["j0"] <= LA.span_chunks(L) * LA.CHUNK   # none past the length
        pos = it["j1"]
    assert pos == L


@pytest.mark.parametrize("H", [1, 16, 17, 40, 48])
@pytest.mark.parametrize("L", LENGTHS)
def test_each_output_is_combined_once_over_the_partials_in_order(L, H):
    """A row of one span writes every output directly; otherwise the slices
    of each head tile's (head, 4 columns) pieces, one an item, are disjoint
    and cover the tile's real heads, so each output is one item's sum over
    the row's n_spans partials (in span order: the kernel's loop p = 0, 1,
    ...)."""
    plan = LA.row_plan(L, H)
    assert len(plan) == LA.n_spans(L) * LA.n_tiles(H)
    for t in range(LA.n_tiles(H)):
        items = [it for it in plan if it["t"] == t]
        pieces = min(LA.TILE, H - LA.TILE * t) * PH
        if LA.n_spans(L) == 1:
            assert [it["direct"] for it in items] == [True]
            continue
        seen = [0] * pieces
        for it in items:
            assert not it["direct"]
            lo, hi = it["slice"]
            assert lo < hi
            for pc in range(lo, hi):
                seen[pc] += 1
        assert seen == [1] * pieces


@pytest.mark.parametrize("L", [1, 64, 65, 577, 1056, 2049])
@pytest.mark.parametrize("form", ["exact", "capacity 2048", "table x2 page 16", "page 7"])
@pytest.mark.parametrize("B", [1, 4])
def test_a_rows_items_depend_on_its_length_alone(B, form, L):
    """A row's live items (span, tile, positions, slice) in a launch are
    row_plan(L)'s, whatever B, the cache's capacity, the table's width or
    the page size, and wherever the row sits in the batch; the slots past
    the length hold no item."""
    H = 40
    if form == "exact":
        n_slot = LA.n_spans(L)
    elif form == "capacity 2048":
        n_slot = LA.span_slots(max(2048, L))
    elif form == "table x2 page 16":
        n_slot = LA.span_slots(2 * 16 * -(-L // 16))
    else:
        n_slot = LA.span_slots(7 * -(-L // 7))
    lengths = [L] * B if form == "exact" else [max(L - 3 * b, 1) if b else L for b in range(B)]
    plan = LA.launch_plan(lengths, H, n_slot, wave=396)
    want = {(it["s"], it["t"]) for it in LA.row_plan(L, H)}
    got = {(s, t) for walk in plan["compute"] for b, s, t in walk if b == 0}
    assert got == want
    for b, Lb in enumerate(lengths):
        items = sorted((s, t) for walk in plan["compute"] for bb, s, t in walk if bb == b)
        assert items == sorted((it["s"], it["t"]) for it in LA.row_plan(Lb, H))


@pytest.mark.parametrize("wave", [1, 7, 132, 396])
@pytest.mark.parametrize("lengths,H,positions", [
    ([1056] * 4, 40, 1056), ([1056], 40, 1056), ([1, 0, 300, 1056], 40, 2048),
    ([5000, 64, 65], 48, 8192), ([2049] * 16, 40, 4096), ([0], 16, 64)])
def test_the_walk_is_one_wave_and_finishes(lengths, H, positions, wave):
    """grid <= wave; every item of the launch in exactly one block's walk;
    each block's products come before its combines; and with every block
    resident (what the one-wave grid gives) a round-robin run of the blocks,
    in which a combine waits until its (row, tile) has counted all of its
    spans, finishes: no block waits on an item that no block will run."""
    n_slot = LA.span_slots(positions)
    plan = LA.launch_plan(lengths, H, n_slot, wave)
    grid = plan["grid"]
    n_items = len(lengths) * n_slot * LA.n_tiles(H)
    assert grid == min(n_items, wave) <= wave
    live = sorted((b, s, t) for b, L in enumerate(lengths)
                  for s in range(LA.n_spans(L)) for t in range(LA.n_tiles(H)))
    assert sorted(x for walk in plan["compute"] for x in walk) == live
    assert sorted(x for walk in plan["combine"] for x in walk) == sorted(
        x for x in live if LA.n_spans(lengths[x[0]]) > 1)
    # each block: its products, then its combines
    todo = [[("compute", x) for x in plan["compute"][k]] + [("combine", x)
                                                           for x in plan["combine"][k]]
            for k in range(grid)]
    counted = {}
    while any(todo):
        moved = False
        for walk in todo:
            if not walk:
                continue
            kind, (b, s, t) = walk[0]
            if kind == "compute":
                counted[b, t] = counted.get((b, t), 0) + 1
            elif counted.get((b, t), 0) < LA.n_spans(lengths[b]):
                continue                          # spins
            walk.pop(0)
            moved = True
        assert moved, "every unfinished block spins: the walk would deadlock"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,positions,exact", [(4, 40, 1056, True), (1, 40, 1056, False),
                                                 (3, 48, 5000, False), (2, 1, 1, True)])
def test_scratch_holds_every_slot_the_kernel_writes(dtype, B, H, positions, exact):
    n_o, n_ml, n_cnt = LA.scratch_sizes(dtype, B, H, positions, exact)
    if dtype == torch.bfloat16:
        n_slot = LA.n_spans(positions) if exact else LA.span_slots(positions)
        slots = B * LA.n_tiles(H) * n_slot
        assert (n_o, n_ml, n_cnt) == (slots * LA.TILE * LA.DV, 2 * slots * LA.TILE,
                                      B * LA.n_tiles(H))
        # the highest slot any row of length <= positions writes
        top = max(LA.n_spans(L) for L in range(0, positions + 1, 7)) - 1
        assert top < n_slot
    else:
        n_p = LA.n_chunks(positions)
        assert (n_o, n_ml, n_cnt) == (B * n_p * H * LA.DV, 2 * B * n_p * H, B)


def test_the_minicpm3_decode_fills_the_card():
    """At minicpm3-4b's last decode step (length 1056, 40 heads) a row is 17
    spans x 3 tiles = 51 items: 51 blocks at one fleet lane, 204 at four
    rows, one each on a wave of three blocks an SM of 132 SMs."""
    assert LA.n_spans(1056) == 17 and LA.n_tiles(40) == 3
    for B, blocks in ((1, 51), (4, 204)):
        plan = LA.launch_plan([1056] * B, 40, LA.n_spans(1056), wave=3 * 132)
        assert plan["grid"] == blocks and all(len(w) == 1 for w in plan["compute"])
