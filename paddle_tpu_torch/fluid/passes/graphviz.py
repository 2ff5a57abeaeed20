"""Program -> Graphviz .dot rendering (BuildStrategy.debug_graphviz_path).

Counterpart of ``paddle_tpu/fluid/passes/graphviz.py`` (framework/ir/
graph_viz_pass.cc): every pass stage can leave a .dot of the program it
saw, the same text for the same program.  Ops render as boxes, vars as
ellipses (persistables shaded), edges follow the named slots.  Pure
string generation: no graphviz binary is needed."""
from __future__ import annotations

import re
from typing import List

__all__ = ["program_to_dot", "dump_program"]

_ID_RE = re.compile(r"[^A-Za-z0-9_]")


def _vid(bidx: int, name: str) -> str:
    return f"v{bidx}_{_ID_RE.sub('_', name)}"


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def program_to_dot(program, title: str = "program") -> str:
    lines: List[str] = [
        f'digraph "{_esc(title)}" {{',
        "  rankdir=TB;",
        '  node [fontsize=10, fontname="Helvetica"];',
    ]
    for b in program.blocks:
        lines.append(f"  subgraph cluster_block{b.idx} {{")
        lines.append(f'    label="block {b.idx}";')
        declared = set()

        def var_node(name: str) -> str:
            nid = _vid(b.idx, name)
            if nid not in declared:
                declared.add(nid)
                v = b._find_var_recursive(name)
                style = ', style=filled, fillcolor="lightgrey"' \
                    if (v is not None and v.persistable) else ""
                shape = f" {list(v.shape)}" if (
                    v is not None and v.shape is not None) else ""
                lines.append(
                    f'    {nid} [label="{_esc(name)}{_esc(shape)}", '
                    f'shape=ellipse{style}];')
            return nid

        for i, op in enumerate(b.ops):
            oid = f"op{b.idx}_{i}"
            lines.append(
                f'    {oid} [label="{_esc(op.type)}", shape=box, '
                f'style=filled, fillcolor="lightblue"];')
            for slot, names in op.inputs.items():
                for n in names:
                    lines.append(
                        f'    {var_node(n)} -> {oid} '
                        f'[label="{_esc(slot)}", fontsize=8];')
            for slot, names in op.outputs.items():
                for n in names:
                    lines.append(
                        f'    {oid} -> {var_node(n)} '
                        f'[label="{_esc(slot)}", fontsize=8];')
        lines.append("  }")
    lines.append("}")
    return "\n".join(lines) + "\n"


def dump_program(program, path: str, title: str = None) -> str:
    with open(path, "w") as f:
        f.write(program_to_dot(program, title or path))
    return path
