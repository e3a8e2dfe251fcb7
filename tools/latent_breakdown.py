#!/usr/bin/env python3
"""Where MLA's latent decode spends its time, phase by phase, and the kernel
against another tree's in turns.

    python3 tools/latent_breakdown.py [--parent DIR [--parent-only]] [--turns N]
                                      [--only 2c|3c] [--clock-only]

Builds ``csrc/latent_decode_attention.cu`` once as shipped and once with
each set of diagnostic macros below (one ``nvcc`` each, all in parallel,
into ``src/repro_torch/_build/breakdown/``), and times every build through
the wrapper's ``library`` hook on rows 2c and 3c of ``PERF.md`` §6, as
``chip_smoke.py`` phase 3 does (the replay of a CUDA graph,
``repro_torch.kernels.timing.cuda_ms``):

- 2c: minicpm3-4b's last decode step, B4 H40, 1056 latent rows of 288 (the
  first 256 the value), contiguous, eight input sets;
- 3c: one fleet lane at length 1056 through a shuffled page table of 16-row
  pages, each call another layer's strided view of one of two 62-layer
  stores.

Each macro cuts the kernel after a phase, so the differences of the builds'
times are the phases: ``LAT_EMPTY`` (every block returns at once: the
launch and the grid's schedule), ``LAT_STAGE_ONLY`` (the rows staged,
nothing computed or written), ``LAT_NO_PL`` (S and the softmax, no P·L),
``LAT_NO_WRITE`` (P·L, no partial or output written), and
``LAT_NOCOMBINE`` (the partials written, the tickets taken, the combine
left out), beside the full kernel. The same positions cut into rows of one
span each (no partial, no combine; 2c: 68 rows of 64 positions, 3c: 17
lanes of four pages each) give the kernel without its combine. A source
that lacks the macros (the previous design's: a block a row's 64
positions, the row's last block combining) gets them by the text
substitutions in ``PARENT_PATCHES``, with the same meaning.

``--parent DIR`` (the root of another checkout, as ``git archive`` unpacks a
parent commit under ``.archive/``) builds that tree's source the same way,
prints its phases too, and times the two shipped builds in turns, parent,
change, change, parent, ``--turns`` times. Each full build's largest
distance from the plain version is printed; ``--parent-only`` times the
other tree alone. A source with ``LAT_CLOCK`` is also built with it, and
one launch's timeline printed: each phase's median and largest time over
the blocks, their SMs and start times (``--clock-only``: that alone).
``--only 2c`` or ``3c`` keeps one row. Needs one CUDA device and nvcc;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PAGE, LAYERS = 16, 62
B, H, LENGTH = 4, 40, 1056
SCALE = 1.0 / (96 ** 0.5)   # minicpm3-4b's: 1/sqrt(qk_nope + rope)
#: build -> its macros, in the order of the phases they add
BUILDS = {
    "empty": ("LAT_EMPTY",),
    "stage": ("LAT_STAGE_ONLY", "LAT_NOCOMBINE"),
    "nopl": ("LAT_NO_PL", "LAT_NOCOMBINE"),
    "nowrite": ("LAT_NO_WRITE", "LAT_NOCOMBINE"),
    "nocombine": ("LAT_NOCOMBINE",),
    "full": (),
}
#: a further build of a source that has its macro: the timeline of one
#: launch (clock64 and globaltimer stamps a block, ``LAT_CLOCK``)
EXTRA = {"clock": ("LAT_CLOCK",)}
STAMPS = ("set up", "row offsets and bytes expected", "barrier", "issue the copies",
          "warp 0's rows land",
          "S", "softmax and P·L", "store the partial", "count it", "spin", "combine")
NF = len(STAMPS) + 4   # the stamps, then the globaltimer at start and end, the SM
PHASES = (("launch and schedule", None, "empty"), ("staging", "empty", "stage"),
          ("S and softmax", "stage", "nopl"), ("P·L", "nopl", "nowrite"),
          ("partials' write", "nowrite", "nocombine"), ("combine", "nocombine", "full"))
#: (anchor, replacement) pairs that give the previous design's
#: latent_mma_kernel the macros above; each anchor occurs once in that
#: source
PARENT_PATCHES = (
    ("  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));\n",
     "  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));\n"
     "#ifdef LAT_EMPTY\n  return;\n#endif\n"),
    ("    const int h0 = warp * 16;\n    if (warp < NWARP && h0 < H) {\n",
     "    const int h0 = warp * 16;\n#ifdef LAT_STAGE_ONLY\n    if (false) {\n#else\n"
     "    if (warp < NWARP && h0 < H) {\n#endif\n"),
    ("#pragma unroll 1\n      for (int c = 0; c < DV / 64; ++c) {\n",
     "#ifdef LAT_NO_PL\n      if (l0 + l1 == 1234.5f) part_l[0] = m0 + m1;\n"
     "      for (int c = 0; c < 0; ++c) {\n#else\n#pragma unroll 1\n"
     "      for (int c = 0; c < DV / 64; ++c) {\n#endif\n"),
    ("          const int col = 64 * c + 8 * t + cq;\n",
     "          const int col = 64 * c + 8 * t + cq;\n#ifdef LAT_NO_WRITE\n"
     "          if (acc[t][0] == 1234.5f) part_o[t] = acc[t][1] + acc[t][2] + acc[t][3];\n"
     "          if (false)\n#endif\n"),
    # its launcher's "allowed" flags out of the named namespace: a static of
    # a template there is one object across every loaded build of the source
    # (GNU unique symbols), so only the first build loaded would get its
    # shared memory allowed
    ("template <typename KV>\nbool* ready_mma() {\n  static bool ready[64];\n  return ready;\n}\n"
     "template <typename KV>\nbool* ready_f32() {\n  static bool ready[64];\n  return ready;\n}\n",
     "}  // namespace latent\nnamespace {\n"
     "template <typename KV>\nbool* ready_mma() {\n  static bool ready[64];\n  return ready;\n}\n"
     "template <typename KV>\nbool* ready_f32() {\n  static bool ready[64];\n  return ready;\n}\n"
     "}  // namespace\nnamespace latent {\n"),
    ("  combine<bf16>(out, part_o, part_m, part_l, b, H, n_p, m_s, den_s);\n",
     "#ifndef LAT_NOCOMBINE\n  combine<bf16>(out, part_o, part_m, part_l, b, H, n_p, m_s, den_s);\n"
     "#endif\n"),
)


def prepare(src_root: Path, tag: str, build) -> Path:
    """Copy a tree's latent source and headers into the breakdown directory,
    patched with the macros if it lacks them; returns the copied .cu."""
    csrc = src_root / "repro_torch" / "csrc"
    out = build.BUILD_ROOT / "breakdown" / f"latent_{tag}"
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for f in csrc.glob("*.cuh"):
        shutil.copy(f, out / f.name)
    text = (csrc / "latent_decode_attention.cu").read_text()
    if "LAT_NOCOMBINE" not in text:
        for old, new in PARENT_PATCHES:
            if text.count(old) != 1:
                raise RuntimeError(f"{tag}: a patch anchor occurs {text.count(old)} times: "
                                   f"{old.strip()[:60]!r}")
            text = text.replace(old, new)
    cu = out / "latent_decode_attention.cu"
    cu.write_text(text)
    return cu


def compile_all(sources: dict, build, clock_only=False) -> dict:
    """One nvcc a (tree, build), all at once; returns {(tag, build): lib}
    and prints ptxas's lines for each tree's shipped build."""
    procs, libs = {}, {}
    for tag, cu in sources.items():
        extra = EXTRA if "LAT_CLOCK" in cu.read_text() else {}
        for name, macros in (({} if clock_only else BUILDS) | extra).items():
            lib = cu.parent / f"lib_{name}.so"
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *(f"-D{m}" for m in macros),
                   *(("-Xptxas", "-v") if name == "full" else ()), "-o", str(lib), str(cu)]
            procs[tag, name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)
            libs[tag, name] = lib
    for key, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        if key[1] == "full":
            for line in log.splitlines():
                if "latent" in line or "Used" in line or "spill" in line:
                    print(f"[ptxas {key[0]}] {line.strip()}")
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout, timed against this one in turns")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--only", choices=("2c", "3c"), default=None)
    ap.add_argument("--parent-only", action="store_true",
                    help="build and time the parent's source alone")
    ap.add_argument("--clock-only", action="store_true",
                    help="this tree's timeline of one launch alone")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("latent_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import latent_decode_attention as LA
    from repro_torch.kernels.timing import cuda_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sources = {} if args.parent_only else {"change": prepare(ROOT / "src", "change", build)}
    if args.parent:
        sources["parent"] = prepare(args.parent.resolve() / "src", "parent", build)
    libs = compile_all(sources, build, clock_only=args.clock_only)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    kw = dict(v_dim=LA.DV, scale=SCALE)
    rows = {}
    if args.only in (None, "2c"):
        many = [(randn(B, H, LA.DK), randn(B, LENGTH, LA.DK)) for _ in range(8)]
        n_one = B * -(-LENGTH // 64)
        one = [(randn(n_one, H, LA.DK), randn(n_one, 64, LA.DK)) for _ in range(8)]
        rows["2c"] = (
            lambda q, lat: LA.latent_decode_attention(q, lat, LENGTH, **kw), many,
            lambda q, lat: LA.latent_decode_attention(q, lat, 64, **kw), one,
            lambda q, lat: ref.naive_latent_decode_attention(q, lat, LENGTH, **kw),
            f"B{B} H{H} length {LENGTH}, contiguous", f"{n_one} rows of 64")
    if args.only in (None, "3c"):
        n = LENGTH // PAGE
        P = n + 3
        stores = [randn(P, PAGE, LAYERS * LA.DK).view(P, PAGE, LAYERS, LA.DK) for _ in range(2)]
        table = torch.randperm(P, generator=torch.Generator().manual_seed(P))[:n]
        table = table.view(1, n).to(torch.int32).to(dev)
        lens = torch.tensor([LENGTH], dtype=torch.int32, device=dev)
        per = 64 // PAGE
        lanes = -(-n // per)
        t_one = torch.zeros(lanes, per, dtype=torch.int32, device=dev)
        l_one = torch.empty(lanes, dtype=torch.int32, device=dev)
        for i in range(lanes):
            pages = table[0, i * per:(i + 1) * per]
            t_one[i, :len(pages)] = pages
            l_one[i] = min(64, LENGTH - 64 * i)
        many = [(randn(1, H, LA.DK), stores[i % 2][:, :, i // 2], table, lens)
                for i in range(2 * LAYERS)]
        one = [(randn(lanes, H, LA.DK), stores[i % 2][:, :, i // 2], t_one, l_one)
               for i in range(2 * LAYERS)]

        def paged(q, pg, t, ln):
            return LA.paged_latent_decode_attention(q, pg, t, ln, **kw)
        rows["3c"] = (paged, many, paged, one,
                      lambda q, pg, t, ln: ref.naive_paged_latent_decode_attention(
                          q, pg, t, ln, **kw),
                      f"B1 H{H} length {LENGTH}, page {PAGE}, {LAYERS}-layer strided store",
                      f"{lanes} lanes of {per} pages")

    def timed(lib, fn, sets):
        LA.library = lib
        try:
            return cuda_ms(fn, sets, iters=40) * 1e3
        except RuntimeError as e:   # a build that fails to launch: its phase reads nan
            print(f"[{lib.parent.name} {lib.name}] {e}", flush=True)
            return float("nan")
        finally:
            LA.library = None

    def timeline(lib, fn, sets):
        """One launch's blocks by their stamps (a LAT_CLOCK build)."""
        import ctypes
        import statistics
        clock = ctypes.CDLL(str(lib)).repro_latent_clock
        clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
        buf = (ctypes.c_longlong * (4096 * NF))()
        LA.library = lib
        try:
            fn(*sets[0])
            torch.cuda.synchronize()
            build.check(clock(buf, 4096), "repro_latent_clock")
            fn(*sets[1])
            torch.cuda.synchronize()
            build.check(clock(buf, 4096), "repro_latent_clock")
        finally:
            LA.library = None
        rows_ = [buf[NF * k:NF * k + NF] for k in range(4096) if buf[NF * k + NF - 3]]
        ghz = statistics.median((r[NF - 4] - r[0]) / max(r[NF - 2] - r[NF - 3], 1)
                                for r in rows_ if r[NF - 4])
        t0 = min(r[NF - 3] for r in rows_)
        per_sm = {}
        for r in rows_:
            per_sm[r[NF - 1]] = per_sm.get(r[NF - 1], 0) + 1

        def us(xs):
            xs = sorted(xs)
            return f"{xs[len(xs) // 2] / 1e3:.2f}/{xs[-1] / 1e3:.2f}"
        parts = [f"{name} {us([(r[k + 1] - r[k]) / ghz for r in rows_ if r[k + 1] and r[k]])}"
                 for k, name in enumerate(STAMPS)]
        return (f"{len(rows_)} blocks on {len(per_sm)} SMs (at most {max(per_sm.values())} an "
                f"SM), {ghz:.3f} cycles a ns; start after the first block "
                f"{us([r[NF - 3] - t0 for r in rows_])}, end "
                f"{us([r[NF - 2] - t0 for r in rows_])}; "
                + ", ".join(parts) + " us (median/max over the blocks)")

    for tag in sources:
        for row, (fn, many, fn1, one, plain, what, cut) in rows.items():
            if (tag, "clock") in libs:
                print(f"[{tag}] {row} one launch: {timeline(libs[tag, 'clock'], fn, many)}",
                      flush=True)
            if args.clock_only:
                continue
            us = {name: timed(libs[tag, name], fn, many) for name in BUILDS}
            us_one = timed(libs[tag, "full"], fn1, one)
            LA.library = libs[tag, "full"]
            try:
                err = (fn(*many[0]).float() - plain(*many[0]).float()).abs().max().item()
            except RuntimeError as e:
                print(f"[{tag}] {row}: {e}", flush=True)
                err = float("nan")
            LA.library = None
            parts = ", ".join(f"{label} {us[b] - (us[a] if a else 0):.2f}"
                              for label, a, b in PHASES)
            print(f"[{tag}] {row} ({what}): " + ", ".join(f"{k} {v:.2f}" for k, v in us.items())
                  + f" us; phases: {parts} us; the same positions as {cut} (no combine) "
                  f"{us_one:.2f} us; max |err| against the plain version {err:.2e}", flush=True)
    if len(sources) == 2:
        for row, (fn, many, *_rest) in rows.items():
            seen = {"parent": [], "change": []}
            for _ in range(args.turns):
                for tag in ("parent", "change", "change", "parent"):
                    seen[tag].append(timed(libs[tag, "full"], fn, many))
            mean = {t: sum(v) / len(v) for t, v in seen.items()}
            print(f"[turns] {row}: parent {mean['parent']:.2f} us "
                  f"({', '.join(f'{x:.2f}' for x in seen['parent'])}), change "
                  f"{mean['change']:.2f} us ({', '.join(f'{x:.2f}' for x in seen['change'])})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
