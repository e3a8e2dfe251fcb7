"""K1's kernels on the CPU, read from their CUDA sources: which bf16 forward
kernel runs at each (head dim, G, window) (``ws_route`` in
``csrc/flash_attention.cu`` against the wrapper's ``fwd_kernel``), which
pairs of q's and v's head dims the kernels take (``pair_ok`` in
``csrc/hopper.cuh`` against the wrapper's), the entries' dispatch, the
register split of the warp-specialized kernels (what the producer
warpgroup gives up covers what the consumers take), the shared-memory plans
of ``flash_ws_kernel`` and the persistent dQ kernel, and the order in which
the kernels take their output tiles (``TileOrder`` and ``grouped_order`` in
``csrc/hopper.cuh``, mirrored here). The kernels themselves run only on the
card (``tests/test_torch_gpu.py``)."""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

SMEM_MAX = 232448   # bytes of shared memory a block may take on an H100
REGS = 65536        # 32-bit registers of an SM


def _fwd():
    return (build.CSRC / "flash_attention.cu").read_text()


def _bwd():
    return (build.CSRC / "flash_attention_bwd.cu").read_text()


def _route_rule():
    """``ws_route``'s expression as Python: a function of (D, G, window)."""
    m = re.search(r"bool ws_route\(int D, int G, int window\) \{\s*return ([^;]+);\s*\}", _fwd())
    assert m, "ws_route not found in flash_attention.cu"
    expr = m.group(1).replace("&&", " and ").replace("||", " or ").replace("!", " not ")
    expr = expr.replace(" not =", "!=")
    return lambda D, G, window: bool(eval(expr, {}, {"D": D, "G": G, "window": window}))


@pytest.mark.parametrize("window", [None, 1024, 50])
@pytest.mark.parametrize("G", [1, 2, 4, 5, 8, 16])
@pytest.mark.parametrize("D", [32, 64, 96, 128])
def test_wrapper_route_mirrors_the_sources(D, G, window):
    """fwd_kernel names the kernel the C entry's ws_route picks, at every
    head dim the forward is built for, G and window."""
    want = "flash_ws_kernel" if _route_rule()(D, G, window or 0) else "flash_bf16_kernel"
    assert FA.fwd_kernel(torch.bfloat16, D, G, window) == want
    assert FA.fwd_kernel(torch.float32, D, G, window) == "flash_f32_kernel"


@pytest.mark.parametrize("row,D,G,window,kernel", [
    ("1 granite-3-2b", 64, 4, None, "flash_ws_kernel"),
    ("1h hymba-1.5b, windowed layers", 64, 5, 1024, "flash_ws_kernel"),
    ("1h hymba-1.5b, global layers", 64, 5, None, "flash_ws_kernel"),
    ("1m minicpm-2b", 64, 1, None, "flash_ws_kernel"),
    ("1q qwen2.5-14b", 128, 5, None, "flash_ws_kernel"),
    ("1c minicpm3-4b, MLA's qk head dim", 96, 1, None, "flash_ws_kernel"),
    ("the smoke configs' head dim", 32, 4, None, "flash_bf16_kernel"),
])
def test_model_shapes_route(row, D, G, window, kernel):
    """Each model's prefill, by the rule the source states."""
    assert _route_rule()(D, G, window or 0) == (kernel == "flash_ws_kernel")
    assert FA.fwd_kernel(torch.bfloat16, D, G, window) == kernel


def test_entry_dispatch_keeps_float32_and_head_dim_32_on_their_kernels():
    """The bf16 route goes to flash_ws_kernel at 64 and 128 (its only
    tile widths; head dim 96 runs on 128's tiles, beside V at its 64 columns
    or padded to 96), each built with its tiles grouped by head and not,
    chosen by grouped_order(G); flash_bf16_kernel keeps head dim 32 (its only
    one), and float32 keeps the scalar kernel at every head dim and pair."""
    src = _fwd()
    body = src[src.index('extern "C" int repro_flash_attention_v('):]
    assert "const bool ws = dtype == 1 && ws_route(D, H / K, window);" in body
    assert "if (ws) return launch_ws_at(D, Dv, grouped_order(H / K), a, B, st);" in body
    table = src[src.index("int launch_ws_as(int D, int Dv,"):src.index("int launch_ws_at(")]
    assert re.findall(r"if \(([^)]+)\) return launch_ws<(\d+), (\d+), (\d+), GROUPED>", table) == [
        ("D == 128", "128", "128", "128"), ("D == 96 && Dv == 64", "128", "96", "64"),
        ("D == 96", "128", "96", "128"), ("D == 64", "64", "64", "64")]
    assert "return grouped ? launch_ws_as<true>(D, Dv, a, B, st) : launch_ws_as<false>(" in src
    assert re.findall(r"return launch_bf16<(\d+)>", body) == ["32"]
    assert "if (dtype == 1 && !ws && D == 32) return launch_bf16<32>(a, B, st);" in body
    for D in (32, 64, 96, 128):
        assert re.search(rf"dtype == 0 && D == {D}\) \{{\s*flash_f32_kernel<{D}>", body)
    assert re.search(r"dtype == 0 && D == 96 && Dv == 64\) \{\s*flash_f32_kernel<96, 64>", body)
    assert "|| !pair_ok(D, Dv))" in body
    assert not _route_rule()(32, 1, 0)


def _namespace(src, name):
    """The text of ``namespace name { ... }`` (to its closing comment)."""
    start = src.index(f"namespace {name} {{")
    return src[start:src.index(f"}}  // namespace {name}", start)]


def _consts(text, known):
    """Evaluate the namespace-level ``constexpr int NAME = expr;`` lines of
    ``text`` in order, starting from ``known`` (a template's members, which
    depend on its parameter, are left out)."""
    env = dict(known)
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text, re.M):
        for decl in re.split(r",\s*(?=\w+ = )", f"{name} = {expr}"):
            n, e = (x.strip() for x in decl.split("=", 1))
            e = e.split("//")[0].replace("/", "//")   # C's integer division
            if m := re.fullmatch(r"(.+?) \? (.+?) : (.+)", e.strip()):   # a ? b : c
                e = f"({m.group(2)}) if ({m.group(1)}) else ({m.group(3)})"
            env[n] = eval(e, {}, env)
    return env


def _fwd_globals():
    src = _fwd()
    g = {}
    for n in ("BQ", "CONSUMERS", "BM"):
        m = re.search(rf"constexpr int {n} = ([^;]+);", src)
        g[n] = eval(m.group(1), {}, g)
    return g


def _launch_regs(threads):
    """Registers a thread gets at launch when one block of ``threads`` fills
    the SM (ptxas allocates in steps of 8)."""
    return REGS // threads // 8 * 8


@pytest.mark.parametrize("kernel", ["flash_ws_kernel", "dq_d128_kernel"])
def test_setmaxnreg_split_gives_the_consumers_what_the_producer_gives_up(kernel):
    """A consumer's setmaxnreg.inc is served from the registers the
    producer warpgroup's setmaxnreg.dec frees: (launch - producer) x 128 >=
    (consumer - launch) x 128 x consumers; the increase waits forever
    otherwise. Both values are multiples of 8 in 24..256, as the
    instruction needs."""
    if kernel == "flash_ws_kernel":
        src = _fwd()
        macros = {m: int(v) for m, v in re.findall(r"#define (FWD_\w+) (\d+)", src)}
        env = _consts(_namespace(src, "ws"), {**_fwd_globals(), **macros})
        nc, threads = env["CONSUMERS"], env["NTHREADS"]
    else:
        env = _consts(_namespace(_bwd(), "dq128"), {"WG_ROWS": 64, "BN": 64})
        nc, threads = env["NC"], env["THREADS"]
    assert threads == 128 * (nc + 1)
    launch = _launch_regs(threads)
    prod, cons = env["PRODUCER_REGS"], env["CONSUMER_REGS"]
    assert all(r % 8 == 0 and 24 <= r <= 256 for r in (prod, cons))
    assert prod <= launch <= cons
    assert (launch - prod) * 128 >= (cons - launch) * 128 * nc
    assert prod * 128 + cons * 128 * nc <= REGS


def _struct(src, name, env):
    """Evaluate the ``static constexpr int NAME = expr;`` members of
    ``struct name`` in order, from ``env`` (its template parameters and the
    names it reads), ``dq128::`` and ``BN`` qualified names included."""
    start = src.index(f"struct {name} {{")
    body = src[start:src.index("\n};", start)]
    env = dict(env)
    for n, e in re.findall(r"static constexpr int (\w+) = ([^;]+);", body):
        if n in env:   # given: a member computed by a function of the source
            continue
        e = e.split("//")[0].replace("dq128::", "").replace("/", "//")
        env[n] = eval(e, {}, env)
    return env


def test_dq128_shared_memory_plan_fits():
    """dq_d128_kernel's plan at each pair of tile widths it is built for
    (Q's and K's D, dO's and V's DV: 128 and 128, MLA's 96 and 64): two Q
    and two dO buffers of 128 rows, a 3-slot ring of 64-row K and V tiles,
    two Dr vectors and its 14 barriers, within the 227 KB a block may take
    (with the 1024-byte alignment slack), every tile on 1024 bytes; O has no
    buffer (the producer's Dr pass reads it from global memory)."""
    ns = _consts(_namespace(_bwd(), "dq128"), {"WG_ROWS": 64, "BN": 64})
    assert ns["BM"] == 128 and ns["SLOTS"] == 3
    for D, DV in ((128, 128), (96, 64)):
        env = _struct(_bwd(), "Dq128Smem", {**ns, "BN": 64, "D": D, "DV": DV})
        assert env["ROWS"] == 128 * D * 2 and env["TILE"] == 64 * D * 2
        assert env["DO_ROWS"] == 128 * DV * 2 and env["V_TILE"] == 64 * DV * 2
        assert env["DO"] - env["Q"] == 2 * env["ROWS"]
        assert env["K"] - env["DO"] == 2 * env["DO_ROWS"]
        assert env["BYTES"] == (2 * env["ROWS"] + 2 * env["DO_ROWS"] + 3 * env["TILE"]
                                + 3 * env["V_TILE"] + 2 * 128 * 4 + 14 * 8 + 1024)
        assert env["BYTES"] <= SMEM_MAX
        assert all(env[n] % 1024 == 0 for n in ("DO", "K", "V", "DR"))
    assert "static constexpr int O = " not in _bwd()[_bwd().index("struct Dq128Smem {"):]


@pytest.mark.parametrize("D", [64, 128])
def test_flash_ws_shared_memory_plan_fits(D):
    """flash_ws_kernel's plan at each head dim it is built for: its Q
    buffers of 128 rows (two at D = 128, one at 64), rings of two 128-row K
    and V tiles, O of two warpgroups' 64 rows and the barriers, within the
    227 KB a block may take."""
    src = _fwd()
    ns = _namespace(src, "ws")
    assert "return D == 128 ? 2 : 1;" in ns
    assert re.search(r"#define FWD_BN 128\b", src)
    g = _fwd_globals()
    qbufs = 2 if D == 128 else 1
    env = _consts(ns, {**g, "FWD_BN": 128})
    slots, bn = env["SLOTS"], env["BN"]
    assert (slots, bn) == (2, 128)
    q_tile, tile = g["BM"] * D * 2, bn * D * 2
    nbytes = (qbufs * q_tile + 2 * slots * tile + g["CONSUMERS"] * g["BQ"] * D * 2
              + (4 * slots + 2 * qbufs + 2 * g["CONSUMERS"]) * 8 + 1024)
    assert nbytes <= SMEM_MAX
    assert "(4 * SLOTS + 2 * QBUFS + 2 * CONSUMERS) * 8 + 1024" in ns


def test_new_kernels_check_their_registers_at_launch():
    """Both launchers read the kernel's register count at launch and refuse
    (cudaErrorInvalidConfiguration) a count the split cannot serve."""
    for src, fn, kernel in ((_fwd(), "int launch_ws(", "flash_ws_kernel<D, DK, DV, GROUPED>"),
                            (_bwd(), "int launch_dq128(", "dq_d128_kernel<D, DK, DV, GROUPED>")):
        body = src[src.index(fn):]
        body = body[:body.index("\n}\n")]
        assert f"cudaFuncGetAttributes(&attr, {kernel})" in body
        assert "cudaErrorInvalidConfiguration" in body


# -- V at its own width (MLA's (96, 64)) and the order of the tiles --------------

def _hopper():
    return (build.CSRC / "hopper.cuh").read_text()


def _c_bool(name, args):
    """A ``constexpr bool name(int a, ...) { return expr; }`` of hopper.cuh
    as Python, with its macros' shipped values."""
    src = _hopper()
    m = re.search(rf"constexpr bool {name}\(([^)]*)\) \{{\s*return ([^;]+);\s*\}}", src)
    assert m, f"{name} not found in hopper.cuh"
    assert [a.split()[-1] for a in m.group(1).split(",")] == list(args)
    macros = {n: int(v) for n, v in re.findall(r"#define (K1_\w+) (\d+)", src)}
    expr = m.group(2).replace("&&", " and ").replace("||", " or ")
    return lambda *vals: bool(eval(expr, {}, {**macros, **dict(zip(args, vals))}))


@pytest.mark.parametrize("D", [16, 32, 48, 64, 96, 128, 256])
def test_pair_rule_mirrors_the_sources(D):
    """pair_ok names the (D, Dv) pairs the C entries take, at every width:
    Dv = D at the built head dims, and MLA's (96, 64); nothing else."""
    rule = _c_bool("pair_ok", ("D", "Dv"))
    for Dv in (16, 32, 48, 64, 96, 128, 256):
        assert FA.pair_ok(D, Dv) == (rule(D, Dv) and D in FA.HEAD_DIMS), (D, Dv)
    assert FA.pair_ok(D, D) == (D in FA.HEAD_DIMS)
    assert FA.pair_ok(D, 64) == (D in (64, 96))


def test_both_entries_dispatch_exactly_the_pairs():
    """The forward's and the backward's C entries refuse a pair pair_ok
    refuses, and route (96, 64) to its own instances (V and O at 64 columns;
    in the backward Q and K on 96's tiles) before (96, 96), which stays on
    128's tiles."""
    fwd = _fwd()[_fwd().index('extern "C" int repro_flash_attention_v('):]
    bwd = _bwd()[_bwd().index('extern "C" int repro_flash_attention_bwd_v('):]
    assert "|| !pair_ok(D, Dv))" in fwd and "|| !pair_ok(D, Dv))" in bwd
    routes = re.findall(r"if \(D == (\d+)( && Dv == 64)?\) return launch<([\d, ]+)>", bwd)
    assert routes == [("128", "", "128"), ("96", " && Dv == 64", "96, 96, 64"),
                      ("96", "", "128, 96"), ("64", "", "64"), ("32", "", "32")]
    assert '"repro_flash_attention_v"' not in fwd   # the entries are named in C only
    for entry, src in (("repro_flash_attention_lse", _fwd()), ("repro_flash_attention", _fwd()),
                       ("repro_flash_attention_bwd", _bwd())):
        # the earlier entries keep their signatures and take v as wide as q
        body = src[src.index(f'extern "C" int {entry}('):]
        body = body[:body.index("\n}\n")]
        assert "int B, int H, int K, int S, int D," in body and "int Dv" not in body
        assert ", D, D, " in body or "return repro_flash_attention_lse(" in body


@pytest.mark.parametrize("G", [1, 2, 3, 5, 7, 8])
def test_grouped_order_rule_mirrors_the_sources(G):
    """The wrapper's grouped_order names the launches whose tiles the
    kernels walk grouped by head (G = 1 at the shipped K1_ORDER)."""
    assert FA.grouped_order(G) == _c_bool("grouped_order", ("G",))(G)
    assert FA.grouped_order(G) == (G == 1)


class TileOrder:
    """``TileOrder`` of ``csrc/hopper.cuh``, statement by statement (C's
    integer division on non-negative values; test_tile_order_source_is_mirrored
    holds the source to these statements)."""

    def __init__(self, heads, n, g, x=0):
        self.heads, self.n, self.g, self.x = heads, n, g, x
        self.per = n // 2
        rounds = heads * self.per // g if self.per else 0
        pair_rounds = rounds - 1 if rounds > 1 else 0
        self.hp = min(pair_rounds * g // self.per, heads) if self.per else 0
        self.n1 = self.hp * self.per
        self.ht = heads - self.hp
        self.tail = self.ht * n + (self.hp if n % 2 else 0)
        r1 = (self.n1 + g - 1) // g
        last = (r1 - 1) * g + (g - 1 - x if (r1 - 1) % 2 else x)
        self.items = r1 - 1 + (last < self.n1) if r1 else 0

    def at(self, i):
        """(head, rank) of tile i."""
        if i < 2 * self.n1:
            p = (i // 2) % self.per
            return i // 2 // self.per, (self.n - 1 - p if i % 2 else p)
        j, m = i - 2 * self.n1, self.n // 2
        if self.n % 2 == 0 or j < m * self.ht:
            return self.hp + j % self.ht, j // self.ht
        j -= m * self.ht
        if j < self.heads:
            return j, m
        j -= self.heads
        return self.hp + j % self.ht, m + 1 + j // self.ht

    def of_block(self, k):
        x, g = self.x, self.g
        if k < 2 * self.items:
            r = k // 2
            return 2 * (r * g + (g - 1 - x if r % 2 else x)) + k % 2
        k -= 2 * self.items
        t = k * g + (g - 1 - x if k % 2 else x)
        return 2 * self.n1 + t if t < self.tail else -1


def test_tile_order_source_is_mirrored():
    """Each statement of the mirror above is in TileOrder's source (blanks
    folded), so the properties below hold of the kernels' walk."""
    src = _hopper()
    body = src[src.index("struct TileOrder {"):]
    body = " ".join(" ".join(line.split("//")[0].split())
                    for line in body[:body.index("\n};")].splitlines())
    for stmt in ("per = n / 2;", "const int rounds = per ? heads * per / g : 0;",
                 "const int pair_rounds = rounds > 1 ? rounds - 1 : 0;",
                 "hp = per ? pair_rounds * g / per : 0;", "if (hp > heads) hp = heads;",
                 "n1 = hp * per;", "ht = heads - hp;", "tail = ht * n + (n % 2 ? hp : 0);",
                 "const int r1 = (n1 + g - 1) / g;",
                 "const int last = (r1 - 1) * g + ((r1 - 1) % 2 ? g - 1 - x : x);",
                 "items = r1 ? r1 - 1 + (last < n1) : 0;",
                 "if (i < 2 * n1) { const int p = (i / 2) % per; *head = i / 2 / per; "
                 "*rank = i % 2 ? n - 1 - p : p; return; }",
                 "int j = i - 2 * n1; const int m = n / 2;",
                 "if (n % 2 == 0 || j < m * ht) { *rank = j / ht; *head = hp + j % ht; return; }",
                 "j -= m * ht; if (j < heads) { *rank = m; *head = j; return; } j -= heads; "
                 "*rank = m + 1 + j / ht; *head = hp + j % ht;",
                 "if (k < 2 * items) { const int r = k / 2; "
                 "return 2 * (r * g + (r % 2 ? g - 1 - x : x)) + k % 2; } k -= 2 * items; "
                 "const int t = k * g + (k % 2 ? g - 1 - x : x); "
                 "return t < tail ? 2 * n1 + t : -1;"):
        assert stmt in body, stmt
    # the kernels walk it with their own block index and grid, and the
    # heaviest-first walk keeps its snake
    for src_ in (_fwd(), _bwd()):
        assert "const TileOrder ord(a.H * B, n_qt, gridDim.x, blockIdx.x);" in src_
        assert "return ord.of_block(k);" in src_ and "return snake_tile(k, total);" in src_
    assert "TileOrder(a.K * B, (a.S + L::BM - 1) / L::BM, sms).at(blockIdx.x, &head, &rank);" \
        in _bwd()


def _work(rank, n, S, window, bm, bn):
    """KV tiles (of bn rows) that the output tile of rank ``rank`` (bm
    query rows, rank 0 the last) walks under the causal mask and window."""
    q0 = (n - 1 - rank) * bm
    lo = (max(q0 - window + 1, 0) // bn) * bn if window else 0
    return (min(q0 + bm, S) - lo + bn - 1) // bn


def _walks(heads, n, g):
    """Each block's tiles, as (head, rank), in the order it takes them."""
    blocks = []
    for x in range(g):
        ord_, tiles, k = TileOrder(heads, n, g, x), [], 0
        while (i := ord_.of_block(k)) >= 0:
            tiles.append(ord_.at(i))
            k += 1
        blocks.append(tiles)
    return blocks


@pytest.mark.parametrize("B,H,S,window,g", [
    (4, 40, 1024, None, 132),    # minicpm3-4b's prefill and training (G = 1)
    (4, 36, 1024, None, 132),    # minicpm-2b's
    (4, 25, 1536, 1024, 132),    # hymba-1.5b's query heads, windowed
    (4, 25, 1536, None, 132),
    (1, 40, 1024, None, 132),
    (2, 8, 300, 100, 24),        # odd tiles a head, the middle one
    (4, 40, 2048, None, 132),
    (2, 10, 640, None, 100),
    (1, 3, 129, None, 6),        # fewer tiles than a grid's blocks
    (4, 40, 1024, None, 114),    # an H100 PCIe's SMs
])
def test_grouped_tile_order_is_a_balanced_permutation_with_few_heads_in_flight(B, H, S, window,
                                                                                g):
    """The grouped walk, as the persistent kernels deal it (the forward:
    128-row KV tiles; dQ: 64-row), takes every (head, rank) tile once; no
    block's work exceeds the blocks' mean by more than the heaviest tile;
    and a round's tiles (the blocks' k-th ones, in flight together) cover
    at most g / (n / 2) + 1 heads plus the tail's, where the heaviest-first
    walk covers g."""
    heads, n = B * H, (S + 127) // 128
    g = min(g, heads * n)
    blocks = _walks(heads, n, g)
    tiles = [t for b in blocks for t in b]
    assert sorted(tiles) == [(h, r) for h in range(heads) for r in range(n)]
    for bn in (128, 64):
        work = [sum(_work(r, n, S, window, 128, bn) for _, r in b) for b in blocks]
        heaviest = max(_work(r, n, S, window, 128, bn) for r in range(n))
        assert max(work) <= sum(work) / g + heaviest, (bn, max(work), sum(work) / g)
    ord_ = TileOrder(heads, n, g)
    for k in range(max(len(b) for b in blocks)):
        in_flight = {b[k][0] for b in blocks if k < len(b)}
        # the items' rounds cover whole heads' pairs; the tail's, its heads
        bound = g // max(n // 2, 1) + 2 if k < 2 * ord_.items else ord_.ht + ord_.hp * (n % 2)
        assert len(in_flight) <= max(bound, 2), (k, len(in_flight), bound)
    if n >= 4 and heads * n >= 4 * g:
        assert ord_.hp >= heads // 2   # most heads go as items


def test_persistent_walk_without_grouping_is_the_snake():
    """The heaviest-first walk that the G > 1 launches keep: tile k g + x in
    even rounds and k g + g - 1 - x in odd ones, rank i / heads."""
    body = _hopper()[_hopper().index("__device__ __forceinline__ int snake_tile("):]
    body = body[:body.index("\n}\n")]
    assert "const int i = k * g + ((k & 1) ? g - 1 - x : x);" in body
    assert "return i < total ? i : -1;" in body
    for src in (_fwd(), _bwd()):
        assert "rank = i / (a.H * B);" in src and "head = i % (a.H * B);" in src


@pytest.mark.parametrize("W,r,col", [(64, 0, 0), (64, 9, 70), (64, 63, 126), (32, 0, 0),
                                     (32, 3, 40), (32, 6, 94), (32, 63, 30)])
def test_swizzled_offset_is_the_tma_layout(W, r, col):
    """swizzled<W> (hopper.cuh): the byte of row r's column col in a tile of
    128-row boxes W columns wide, as the TMA writes it: box col / W, then
    the 16-byte piece p of the row at p XOR (address bits 7-9 for the
    128-byte swizzle, 7-8 for the 64-byte one)."""
    src = _hopper()
    assert "const int sp = W == 64 ? p ^ (r % 8) : p ^ ((r >> 1) % 4);" in src
    rows = 128
    plain = (col // W) * rows * W * 2 + r * W * 2 + (col % W) * 2   # unswizzled
    within = plain % (rows * W * 2)
    span = 8 if W == 64 else 4
    swz = plain ^ (((within >> 7) % span) << 4)
    c, p = col % W, (col % W) // 8
    sp = p ^ (r % 8) if W == 64 else p ^ ((r >> 1) % 4)
    assert (col // W) * rows * W * 2 + r * W * 2 + sp * 16 + (c % 8) * 2 == swz


def test_mla_plans_fit():
    """The (96, 64) instances' shared memory: flash_ws_kernel<128, 96, 64>
    (Q and K on 128's tiles, V's ring and O at 64) and
    dkdv_bf16_kernel<96, 96, 64> (K at 96, V at 64, a 4-slot ring of 64-row
    Q and dO tiles), each tile on 1024 bytes, within the 227 KB a block may
    take."""
    g = _fwd_globals()
    ws = _consts(_namespace(_fwd(), "ws"), {**g, "FWD_BN": 128})
    assert "return D == 128 ? 2 : 1;" in _namespace(_fwd(), "ws")   # qbufs<128>()
    env = _struct(_fwd(), "Layout", {**g, **ws, "D": 128, "DV": 64, "QBUFS": 2})
    assert env["V_TILE"] == 128 * 64 * 2 and env["O_WG"] == 64 * 64 * 2
    assert env["BYTES"] <= SMEM_MAX and all(env[n] % 1024 == 0 for n in ("K", "V", "O"))
    bwd = _bwd()
    assert "return D == 128 ? 32 : 64;" in bwd and "return D > 64 ? 4 : 3;" in bwd
    kv = _struct(bwd, "KvSmem", {"D": 96, "DV": 64, "BN": 64, "STAGES": 4, "BM": 128})
    assert kv["TILE"] == 64 * 96 * 2 and kv["DO_TILE"] == 64 * 64 * 2
    assert kv["BYTES"] <= SMEM_MAX
    assert all(kv[n] % 1024 == 0 for n in ("V", "Q", "DO"))
