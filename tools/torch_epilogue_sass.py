#!/usr/bin/env python3
"""SASS instruction counts of the epilogue and fold kernels (csrc/epilogue.cu).

    python3 tools/torch_epilogue_sass.py [--parent ROOT] [--keep DIR]

Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), not a GPU.  For this
checkout (and the one at ``--parent``):

  * ``kernels``: each ``__global__`` function of csrc/epilogue.cu built as
    the library builds it (ozimmu_tpu_torch/native.py's flags, into a
    cubin): its static SASS instructions, registers and spill bytes from
    ``ptxas -v``, and its element loops (:func:`element_loops`): each
    innermost loop that writes the output, its instructions and the
    output elements one trip writes, so instructions per element;
  * ``built_per_element``: the count per element of each case, from the
    built instantiation that runs it (its widest element loop: the
    epilogue's 4-column body where it has one; a loop over the fold's
    steps counted once per step of the case).  Static: every instruction
    of the loop body counts, a branch's both sides and the calls to the
    out-of-line fallbacks too (not the fallbacks' bodies);
  * ``per_element``: a model of the arithmetic, not the built kernels:
    probe kernels compiled against that checkout's csrc/tf32x3.cuh run
    one element of each case straight through (load S, E and c, the
    scalars' multiplications, the aligned add, the pack, the store), with
    no exponent forming, addressing, vector loads or loop; branches that
    an admitted element never takes are counted too.  The epilogue's six
    branch combinations (alpha != 1, beta != 0, beta != 1) and the fold
    with alpha = 1 (four steps) and with complex alpha, beta and c (twelve
    steps).

Prints one JSON object per checkout.  :func:`report` gives the same for
``chip_smoke.py``'s ``[build]`` lines.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
#include <cstdint>
#include "tf32x3.cuh"

struct Sc { float t0, t1, t2; int32_t e; float f0, f1; };
struct Plan { Sc s[12]; };

#if OZ_SCALAR_MUL
__device__ __forceinline__ oz::Triple MUL(oz::Triple x, const Sc& f) {
  return oz::mul_scalar(x, {f.t0, f.t1, f.t2}, f.f0, f.f1);
}
#else
__device__ __forceinline__ oz::Triple MUL(oz::Triple x, const Sc& f) { return oz::mul(x, {f.t0, f.t1, f.t2}); }
#endif
__device__ __forceinline__ oz::Triple UNPACK(double c, int32_t& e) { return oz::unpack_f64(c, e); }
__device__ __forceinline__ int64_t PACK(oz::Triple t, int32_t e) { return oz::pack_f64(t, e); }

template <bool ALPHA, bool BETA, bool BETA_SCALE>
__global__ void probe_epilogue(const float* __restrict__ s, const int32_t* __restrict__ e,
                               const double* __restrict__ c, double* __restrict__ out, Sc alpha,
                               Sc beta) {
  const int i = threadIdx.x;
  oz::Triple S = {s[i], s[i + 32], s[i + 64]};
  int32_t E = e[i];
  if (ALPHA) { S = MUL(S, alpha); E += alpha.e; }
  if (BETA) {
    int32_t cE;
    oz::Triple ct = UNPACK(c[i], cE);
    if (BETA_SCALE) { ct = MUL(ct, beta); cE += beta.e; }
    S = oz::aligned_add(S, E, ct, cE, E);
  }
  out[i] = __longlong_as_double(PACK(S, E));
}
template __global__ void probe_epilogue<false, false, false>(const float*, const int32_t*, const double*, double*, Sc, Sc);
template __global__ void probe_epilogue<true, false, false>(const float*, const int32_t*, const double*, double*, Sc, Sc);
template __global__ void probe_epilogue<false, true, false>(const float*, const int32_t*, const double*, double*, Sc, Sc);
template __global__ void probe_epilogue<true, true, false>(const float*, const int32_t*, const double*, double*, Sc, Sc);
template __global__ void probe_epilogue<false, true, true>(const float*, const int32_t*, const double*, double*, Sc, Sc);
template __global__ void probe_epilogue<true, true, true>(const float*, const int32_t*, const double*, double*, Sc, Sc);

__device__ __forceinline__ void step(const Sc& f, const oz::Triple& v, int32_t ve, oz::Triple& acc,
                                     int32_t& acc_e) {
  acc = oz::aligned_add(acc, acc_e, MUL(v, f), ve + f.e, acc_e);
}

// CASE 0: zfold_plan(1, 0), four steps; CASE 1: zfold_plan(2 - 0.5i,
// 0.25 + 1i) with c, twelve
template <int CASE>
__global__ void probe_zfold(const float* __restrict__ s, const int32_t* __restrict__ e,
                            const double* __restrict__ c, double* __restrict__ out, Plan f) {
  const int i = threadIdx.x;
  oz::Triple S[4];
  int32_t E[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    S[p] = {s[i + 96 * p], s[i + 96 * p + 32], s[i + 96 * p + 64]};
    E[p] = e[i + 32 * p];
  }
  oz::Triple re = {0.0f, 0.0f, 0.0f}, im = {0.0f, 0.0f, 0.0f};
  int32_t re_e = -(1 << 20), im_e = -(1 << 20);
  if (CASE == 0) {
    step(f.s[0], S[0], E[0], re, re_e);
    step(f.s[1], S[1], E[1], re, re_e);
    step(f.s[2], S[2], E[2], im, im_e);
    step(f.s[3], S[3], E[3], im, im_e);
  } else {
    int32_t ce[2];
    const oz::Triple ct[2] = {UNPACK(c[i], ce[0]), UNPACK(c[i + 32], ce[1])};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      step(f.s[k], ct[k / 2], ce[k / 2], k % 2 ? im : re, k % 2 ? im_e : re_e);
#pragma unroll
    for (int k = 4; k < 12; ++k) {
      const int p = (k - 4) / 2;
      step(f.s[k], S[p], E[p], k % 2 ? im : re, k % 2 ? im_e : re_e);
    }
  }
  out[i] = __longlong_as_double(PACK(re, re_e));
  out[i + 32] = __longlong_as_double(PACK(im, im_e));
}
template __global__ void probe_zfold<0>(const float*, const int32_t*, const double*, double*, Plan);
template __global__ void probe_zfold<1>(const float*, const int32_t*, const double*, double*, Plan);
"""

#: the probes by case name, in the template arguments' mangled form
PROBES = {
    "epilogue alpha=1 beta=0": "probe_epilogueILb0ELb0ELb0E",
    "epilogue alpha beta=0": "probe_epilogueILb1ELb0ELb0E",
    "epilogue alpha=1 beta=1": "probe_epilogueILb0ELb1ELb0E",
    "epilogue alpha beta=1 (HPL: -1, 1)": "probe_epilogueILb1ELb1ELb0E",
    "epilogue alpha=1 beta": "probe_epilogueILb0ELb1ELb1E",
    "epilogue alpha beta": "probe_epilogueILb1ELb1ELb1E",
    "fold alpha=1 (4 steps)": "probe_zfoldILi0E",
    "fold complex alpha, beta, c (12 steps)": "probe_zfoldILi1E",
}


def _flags():
    sys.path.insert(0, HERE)
    from ozimmu_tpu_torch import native

    return [f for f in native.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")], native


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{name} not found on PATH or under $CUDA_HOME/bin")
    return path


def _cubin(src: str, out: str, include: str, extra=()) -> str:
    """Compile ``src`` to the cubin ``out``; return ptxas's -v output."""
    flags, _ = _flags()
    proc = subprocess.run([_tool("nvcc"), *flags, *extra, "-I", include, "-cubin", src, "-o", out],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def functions(text: str) -> dict:
    """``cuobjdump -sass`` output as {mangled name: [(address, instruction)]},
    NOPs left out."""
    funcs, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m[1]
            funcs[fn] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if fn and m and not re.match(r"NOP\b", m[2]):
            funcs[fn].append((int(m[1], 16), m[2]))
    return funcs


def _sass(cubin: str) -> str:
    return subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout


def sass_counts(funcs: dict) -> dict:
    """Instructions of each function of :func:`functions`.  The bodies of
    out-of-line callees, which cuobjdump lists after their caller's code
    (from the first ``CALL.REL`` target on), are left out: what is counted
    is the caller's own code."""
    counts = {}
    for fn, ins in funcs.items():
        targets = [int(t, 16) for _, op in ins
                   for t in re.findall(r"CALL\.REL\S*\s+(0x[0-9a-f]+)", op)]
        end = min(targets, default=None)
        counts[fn] = sum(1 for addr, _ in ins if end is None or addr < end)
    return counts


def element_loops(ins, outputs: int) -> list:
    """The element loops of one kernel's instructions ``ins``: each loop
    (a backward ``BRA`` and its target) that stores to global memory and
    holds no inner loop that does.  For each: its instructions less those
    of the loops inside it (``instructions``), the largest of those inner
    loops (``step_loop``: a fold that loops over its plan's steps at run
    time runs it once per step), and the output elements a trip writes (``elements``): the
    FP64 pack's one ``DMUL`` per output value where the kernel packs
    through FP64 (a vector body holds both a wide and a one-column store
    path, so its stores do not count its elements), else its ``STG``
    stores, each over ``outputs`` values an element (2 for the fold)."""
    loops = []
    for addr, op in ins:
        m = re.search(r"\bBRA\S*\s+(0x[0-9a-f]+)", op)
        if m and int(m[1], 16) < addr:
            loops.append((int(m[1], 16), addr))

    def body(lo, hi):
        return [op for a, op in ins if lo <= a <= hi]

    def stores(lo, hi):
        return sum(1 for op in body(lo, hi) if re.match(r"(@!?U?P\w+\s+)?STG\b", op))

    fp64_pack = any(re.match(r"(@!?U?P\w+\s+)?DMUL\b", op) for _, op in ins)
    out = []
    for lo, hi in sorted(set(loops)):
        inner = [(a, b) for a, b in set(loops) if (a, b) != (lo, hi) and lo <= a and b <= hi]
        if not stores(lo, hi) or any(stores(a, b) for a, b in inner):
            continue
        n_inner = [len(body(a, b)) for a, b in inner]
        ops = body(lo, hi)
        values = (sum(1 for op in ops if re.match(r"(@!?U?P\w+\s+)?DMUL\b", op)) if fp64_pack
                  else stores(lo, hi))
        elements = values // outputs
        own = len(ops) - sum(n_inner)
        out.append({"loop": f"{lo:#x}-{hi:#x}", "instructions": own, "elements": elements,
                    "per_element": own / elements if elements else None,
                    "step_loop": max(n_inner, default=0)})
    return out


def _ptxas(log: str) -> dict:
    """Registers and spill bytes of each entry in a ``ptxas -v`` log."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            fn = m[1]
            out.setdefault(fn, {})
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn]["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m[1])
    return out


def _short(mangled: str) -> str:
    """A readable name: the kernel and its template arguments."""
    m = re.search(r"([a-z_]+_kernel)(I(?:L[ib]-?\d+E)+)?", mangled)
    if not m:
        return mangled
    targs = re.findall(r"L[ib](-?\d+)E", m[2] or "")
    return m[1] + (f"<{', '.join(targs)}>" if targs else "")


#: each case's instantiation: the epilogue's (alpha != 1, beta != 0,
#: beta != 1) after the exponents' route (0: by their parts) where the
#: kernel has that argument; the fold's steps
CASES = {
    "epilogue alpha=1 beta=0": (0, 0, 0),
    "epilogue alpha beta=0": (1, 0, 0),
    "epilogue alpha=1 beta=1": (0, 1, 0),
    "epilogue alpha beta=1 (HPL: -1, 1)": (1, 1, 0),
    "epilogue alpha=1 beta": (0, 1, 1),
    "epilogue alpha beta": (1, 1, 1),
    "fold alpha=1 (4 steps)": 4,
    "fold complex alpha, beta, c (12 steps)": 12,
}


def built_per_element(kernels: dict) -> dict:
    """Each case of :data:`CASES`: instructions per element of the built
    instantiation that runs it (:func:`report`'s ``kernels``), from its
    element loop that writes the most elements a trip.  A fold with all
    twelve step slots in that loop's body, each behind a uniform branch,
    counts the same for every case (four steps run at alpha = 1)."""
    out = {}
    for case, key in CASES.items():
        if isinstance(key, int):
            # the plane instantiation (one before the interleaved output)
            k = kernels.get("zfold_kernel<0>") or kernels.get("zfold_kernel")
            extra = key
        else:
            args = ", ".join(map(str, key))
            k = kernels.get(f"epilogue_kernel<0, {args}>") or kernels.get(f"epilogue_kernel<{args}>")
            extra = 0
        loops = [lp for lp in (k or {}).get("element_loops", []) if lp["elements"]]
        if not loops:
            out[case] = None
            continue
        lp = max(loops, key=lambda x: x["elements"])
        out[case] = (lp["instructions"] + extra * lp["step_loop"]) / lp["elements"]
    return out


def report(root: str = HERE, keep: str = None) -> dict:
    """The kernels' and the probes' counts for the checkout at ``root``;
    ``keep``: a directory to leave the cubins, their SASS and the probes'
    source in."""
    csrc = os.path.join(os.path.abspath(root), "ozimmu_tpu_torch", "csrc")
    scalar_mul = "mul_scalar" in open(os.path.join(csrc, "tf32x3.cuh")).read()
    with tempfile.TemporaryDirectory(prefix="oz_sass_") as tmp:
        if keep:
            tmp = keep
            os.makedirs(tmp, exist_ok=True)
        kcubin = os.path.join(tmp, "epilogue.cubin")
        log = _cubin(os.path.join(csrc, "epilogue.cu"), kcubin, csrc)
        regs = _ptxas(log)
        text = _sass(kcubin)
        if keep:
            with open(os.path.join(tmp, "epilogue.sass.txt"), "w") as f:
                f.write(text)
        funcs = functions(text)
        kernels = {}
        for fn, n in sass_counts(funcs).items():
            if "_kernel" in fn:
                kernels[_short(fn)] = {
                    "sass": n, **regs.get(fn, {}),
                    "element_loops": element_loops(funcs[fn], 2 if "zfold" in fn else 1)}
        probe = os.path.join(tmp, "probe.cu")
        with open(probe, "w") as f:
            f.write(PROBE)
        pcubin = os.path.join(tmp, "probe.cubin")
        _cubin(probe, pcubin, csrc, (f"-DOZ_SCALAR_MUL={int(scalar_mul)}",))
        counts = sass_counts(functions(_sass(pcubin)))
    per_element = {}
    for case, stem in PROBES.items():
        hits = [n for fn, n in counts.items() if stem in fn]
        per_element[case] = hits[0] if hits else None
    return {"root": os.path.abspath(root), "kernels": kernels,
            "built_per_element": built_per_element(kernels), "per_element": per_element}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a second checkout to count beside this one")
    ap.add_argument("--keep", default=None,
                    help="leave each checkout's cubins, their SASS and the probe source in "
                         "KEEP/<checkout>")
    args = ap.parse_args(argv)
    roots = [("this", HERE)] + ([("parent", args.parent)] if args.parent else [])
    for which, root in roots:
        keep = os.path.join(args.keep, which) if args.keep else None
        print(json.dumps({"checkout": which, **report(root, keep)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
