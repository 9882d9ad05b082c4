"""operand-dag: manifest wait gates must match the declared operand DAG.

``OPERAND_DAG`` in ``state/operands.py`` is the single source of truth for
operand ordering: the renderer feeds each state's declared parents into its
templates as ``wait_barriers``, the kubelet simulator gates pod readiness
on the same list, and the join-bench pipelining math assumes nothing else
serializes a rollout. A *literal* wait target hand-written into a manifest
template — ``wait_for(data, "driver")`` or a raw ``--for=driver`` init
arg — bypasses that declaration: the DS silently re-serializes behind a
barrier the DAG says it doesn't need (undoing the pipelined join), or
worse, waits on a barrier nothing writes and never rolls out. The rule
cross-checks every manifest template against the DAG and flags undeclared
literal targets, anchored at the ``OPERAND_DAG`` assignment so the fix
(declare the edge, or drop the stray gate) lands in the right file.

Macro-driven gates (``--for={{ barrier }}`` expanding ``wait_barriers``)
are by construction declared and never flagged.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Tuple

from ..core import Checker, FileContext, Finding, register

#: literal second argument to the wait_for macro: wait_for(data, "driver")
_WAIT_FOR_CALL = re.compile(
    r"""wait_for\s*\([^,)]*,\s*["']([A-Za-z0-9_-]+)["']""")

#: literal --for target in init args; a templated ``--for={{ barrier }}``
#: starts with "{" and cannot match the token class
_FOR_ARG = re.compile(r"--for[= ]([A-Za-z0-9_-]+)")


def _manifest_state(relpath: str) -> Optional[str]:
    """``tpu_operator_torch/manifests/<state>/x.yaml`` -> ``<state>``; None for
    shared includes and paths outside a state dir."""
    parts = relpath.split("/")
    if "manifests" not in parts:
        return None
    tail = parts[parts.index("manifests") + 1:]
    if len(tail) < 2:  # a file directly under manifests/ has no state dir
        return None
    state = tail[0]
    if state.startswith("_"):  # _includes: macro definitions, no DS of their own
        return None
    return state


def _literal_targets(text: str) -> List[Tuple[str, int]]:
    """(target, line) pairs for every literal wait target in one template."""
    out: List[Tuple[str, int]] = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        for regex in (_WAIT_FOR_CALL, _FOR_ARG):
            for m in regex.finditer(line):
                out.append((m.group(1), lineno))
    return out


@register
class OperandDagChecker(Checker):
    name = "operand-dag"
    description = ("manifest wait_for/--for targets must be declared as "
                   "DAG parents in state/operands.py OPERAND_DAG: an "
                   "undeclared literal gate re-serializes the pipelined "
                   "join (or deadlocks on a barrier nothing writes)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.relpath.endswith("state/operands.py"):
            return
        texts = ctx.config.manifest_texts
        if not texts:
            return
        dag_node: Optional[ast.stmt] = None
        dag: Optional[Dict[str, tuple]] = None
        for node in ctx.tree.body:
            # the registry is annotated (``OPERAND_DAG: Dict[...] = {...}``):
            # an Assign-only match leaves the rule dead on the real tree
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(node, ast.AnnAssign)
                       and node.value is not None else [])
            if any(isinstance(t, ast.Name) and t.id == "OPERAND_DAG"
                   for t in targets):
                try:
                    dag = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    dag = None
                dag_node = node
        if dag_node is None or not isinstance(dag, dict):
            return
        for relpath in sorted(texts):
            state = _manifest_state(relpath)
            if state is None:
                continue
            declared = set(dag.get(state, ()) or ())
            for target, lineno in _literal_targets(texts[relpath]):
                if target in declared:
                    continue
                yield ctx.finding(
                    dag_node, self,
                    f"{relpath}:{lineno} gates on barrier {target!r} but "
                    f"OPERAND_DAG[{state!r}] declares "
                    f"{sorted(declared) or 'no parents'} — declare the "
                    "edge here or drop the stray wait gate from the "
                    "template")
