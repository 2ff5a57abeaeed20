"""Count a kernel's loop instructions by pipe in its SASS, on the machine
with the CUDA toolkit.

    python3 paddle_tpu_torch/tools/sass_count.py SOURCE.cu KERNEL \\
        [--per-pass N] [--label TEXT]

Compiles SOURCE.cu to a cubin for sm_90a with the port's nvcc flags (into
a temporary directory), dumps it with ``cuobjdump -sass`` and takes the
first function whose mangled name contains KERNEL.  In that function it
finds the outermost loop (the backward branch that spans the most
instructions) and, inside it, the path from the loop's head to its back
branch that passes the loop's widest global store: the path a pass of
the loop takes when it writes a whole vector, not the tail.  It counts
that path's instructions by pipe (FMA: IMAD*, IMUL, FFMA, FMUL, FADD;
ALU: LOP3, ISETP, IADD3, SHF, SEL, PRMT, LEA, ...; memory; uniform;
control; other), divides by ``--per-pass`` (the units of work one pass
does, e.g. Philox groups of four), and prints the counts and every
opcode's count on that path.
"""

import argparse
import collections
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

PIPES = (
    ("fma", ("IMAD", "IMUL", "FFMA", "FMUL", "FADD", "HFMA2", "HMUL2",
             "HADD2", "IDP")),
    ("alu", ("LOP3", "LOP", "ISETP", "IADD3", "IADD", "SHF", "SEL", "PRMT",
             "LEA", "FSETP", "FSEL", "IMNMX", "VIMNMX", "FMNMX", "P2R", "R2P",
             "PLOP3", "MOV", "IABS", "FLO", "BMSK", "SGXT", "BREV", "POPC")),
    ("memory", ("LDG", "STG", "LDS", "STS", "LDL", "STL", "LD", "ST", "LDC",
                "ATOM", "ATOMG", "RED", "LDGSTS")),
    ("control", ("BRA", "EXIT", "BSSY", "BSYNC", "WARPSYNC", "NOP", "CALL",
                 "RET", "BAR", "BPT", "YIELD")),
)

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")


def pipe_of(opcode):
    base = opcode.split(".")[0]
    if base.startswith("U") and base not in ("UNUSED",):
        return "uniform"
    for pipe, names in PIPES:
        if base in names:
            return pipe
    return "other"


def sass_functions(text):
    """{mangled name: [(address, predicated, opcode, branch target)]}; a
    branch's target is an address, printed as one or as a label."""
    funcs, name, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.match(r"\s*(?:Function|\.text\.)\s*:?\s*(\S+?):?\s*$", line)
        if m and "Function" in line:
            name = m.group(1)
            funcs[name], labels[name], pending = [], {}, []
            continue
        m = re.match(r"\s*(\.L\w+):", line)
        if m and name:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m and name:
            a = int(m.group(1), 16)
            for label in pending:
                labels[name][label] = a
            pending = []
            funcs[name].append([a, bool(m.group(2)), m.group(3),
                                m.group(4)])
    for name, insns in funcs.items():
        for insn in insns:
            rest = insn[3]
            t = re.search(r"(\.L\w+)", rest)
            if t:
                insn[3] = labels[name].get(t.group(1))
            else:
                t = re.search(r"0x([0-9a-f]+)", rest)
                insn[3] = int(t.group(1), 16) if t and \
                    insn[2].startswith("BRA") else None
    return funcs


def main_path(insns):
    """The loop's instructions on the path through its widest store."""
    addr = [a for a, _, _, _ in insns]
    index = {a: i for i, a in enumerate(addr)}
    loops = []
    for i, (a, pred, op, t) in enumerate(insns):
        if op.startswith("BRA"):
            if t is not None and t in index and t <= a:
                loops.append((i - index[t], index[t], i))
    if not loops:
        raise SystemExit("sass_count: no loop in the function")
    _, head, back = max(loops)
    body = range(head, back + 1)
    stores = [i for i in body if insns[i][2].startswith("STG")]
    if not stores:
        raise SystemExit("sass_count: the loop stores nothing")

    def width(i):
        m = re.search(r"\.(128|64|U8|U16|S8|S16)\b", insns[i][2])
        return {"128": 128, "64": 64, "U8": 8, "S8": 8, "U16": 16,
                "S16": 16}.get(m.group(1), 32) if m else 32

    store = max(stores, key=width)

    # successors inside the body: fall through unless an unconditional
    # branch or exit; a branch's target when it lies inside the body
    def succ(i):
        a, pred, op, t = insns[i]
        out = []
        if op.startswith("BRA"):
            if t is not None and head <= index.get(t, -1) <= back \
                    and i != back:
                out.append(index[t])
            if pred and i + 1 <= back:
                out.append(i + 1)
        elif not op.startswith("EXIT") or pred:
            if i + 1 <= back:
                out.append(i + 1)
        return [j for j in out if j > i]      # no inner back edges

    # shortest path head -> store -> back (a DAG once back edges go)
    def shortest(src, dst):
        best = {src: [src]}
        for i in body:
            if i not in best:
                continue
            for j in succ(i):
                if j not in best or len(best[i]) + 1 < len(best[j]):
                    best[j] = best[i] + [j]
        if dst not in best:
            raise SystemExit("sass_count: no path through the store")
        return best[dst]

    path = shortest(head, store) + shortest(store, back)[1:]
    return [insns[i] for i in path], width(store)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source")
    ap.add_argument("kernel")
    ap.add_argument("--per-pass", type=float, default=1.0)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    from paddle_tpu_torch.ops.cuda_kernels import NVCC_FLAGS, _nvcc

    nvcc = _nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC", "-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, args.source],
                       check=True)
        text = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    funcs = sass_functions(text)
    names = [n for n in funcs if args.kernel in n]
    if not names:
        raise SystemExit(f"sass_count: no function matching {args.kernel} "
                         f"in {sorted(funcs)}")
    name = names[0]
    path, store_bits = main_path(funcs[name])
    by_pipe = collections.Counter(pipe_of(op) for _, _, op, _ in path)
    by_op = collections.Counter(op for _, _, op, _ in path)
    n = args.per_pass
    print(f"sass_count {args.label or args.source}: {name}, "
          f"{len(funcs[name])} instructions in all; the loop's path through "
          f"its {store_bits}-bit store: {len(path)} instructions a pass, "
          f"{len(path) / n:g} per unit ({n:g} a pass)")
    print("  per unit by pipe: " + ", ".join(
        f"{p} {c / n:g}" for p, c in sorted(by_pipe.items())))
    print("  opcodes a pass: " + ", ".join(
        f"{op} {c}" for op, c in sorted(by_op.items())))


if __name__ == "__main__":
    main()
