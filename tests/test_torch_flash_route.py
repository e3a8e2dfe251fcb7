"""K1's kernels on the CPU, read from their CUDA sources: which bf16 forward
kernel runs at each (head dim, G, window) (``ws_route`` in
``csrc/flash_attention.cu`` against the wrapper's ``fwd_kernel``), the
entry's dispatch, the register split of the warp-specialized kernels
(what the producer warpgroup gives up covers what the consumers take),
and the shared-memory plans of ``flash_ws_kernel`` and the head-dim-128
dQ kernel. The kernels themselves run only on the card
(``tests/test_torch_gpu.py``)."""
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
    tile widths; head dim 96 runs on 128's tiles), flash_bf16_kernel keeps
    head dim 32 (its only one), and float32 keeps the scalar kernel at every
    head dim."""
    src = _fwd()
    body = src[src.index('extern "C" int repro_flash_attention_lse('):]
    assert "const bool ws = dtype == 1 && ws_route(D, H / K, window);" in body
    assert sorted(re.findall(r"if \(ws && D == (\d+)\) return launch_ws<(\d+)>", body)) == \
        [("128", "128"), ("64", "64")]
    assert "if (ws && D == 96) return launch_ws<128, 96>(a, B, st);" in body
    assert re.findall(r"return launch_bf16<(\d+)>", body) == ["32"]
    assert "if (dtype == 1 && !ws && D == 32) return launch_bf16<32>(a, B, st);" in body
    for D in (32, 64, 96, 128):
        assert re.search(rf"dtype == 0 && D == {D}\) \{{\s*flash_f32_kernel<{D}>", body)
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


def test_dq128_shared_memory_plan_fits():
    """dq_d128_kernel's plan: two Q and two dO buffers of 128 rows, a 3-slot
    ring of 64-row K and V tiles, two Dr vectors and its 14 barriers,
    within the 227 KB a block may take (with the 1024-byte alignment
    slack); O has no buffer (the producer's Dr pass reads it from global
    memory)."""
    env = _consts(_namespace(_bwd(), "dq128"), {"WG_ROWS": 64, "BN": 64})
    assert env["D"] == 128 and env["BM"] == 128 and env["SLOTS"] == 3
    assert env["ROWS"] == 128 * 128 * 2 and env["TILE"] == 64 * 128 * 2
    assert env["K"] - env["DO"] == 2 * env["ROWS"] and env["DO"] - env["Q"] == 2 * env["ROWS"]
    assert env["BYTES"] == 4 * env["ROWS"] + 6 * env["TILE"] + 2 * 128 * 4 + 14 * 8 + 1024
    assert env["BYTES"] <= SMEM_MAX
    assert not re.search(r"constexpr int O = ", _namespace(_bwd(), "dq128"))


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
    for src, fn, kernel in ((_fwd(), "int launch_ws(", "flash_ws_kernel<D, DK>"),
                            (_bwd(), "int launch_dq128(", "dq_d128_kernel<DK>")):
        body = src[src.index(fn):]
        body = body[:body.index("\n}\n")]
        assert f"cudaFuncGetAttributes(&attr, {kernel})" in body
        assert "cudaErrorInvalidConfiguration" in body
