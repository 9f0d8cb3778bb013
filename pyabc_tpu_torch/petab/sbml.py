"""Minimal SBML subset parser and math-expression evaluator (no libsbml).

Port of ``pyabc_tpu/petab/sbml.py``, plain Python with a math table over
``torch`` functions.  The subset covers reaction-network and rate-rule
models:

- ``listOfCompartments`` / ``listOfSpecies`` / ``listOfParameters``
- ``listOfReactions`` with MathML kinetic laws
- ``listOfRules``: rateRule and assignmentRule

Unsupported constructs (events, function definitions, initial
assignments, constraints, piecewise, amounts outside a unit compartment,
``hasOnlySubstanceUnits``) raise :class:`ExprError` instead of simulating
something else.

MathML is converted to infix strings; infix strings (PEtab observable
and noise formulas use them directly) are parsed with Python's ``ast``
module, checked against a whitelist, compiled once per formula and
evaluated against an environment of tensors and floats.  A call whose
arguments are all plain numbers is computed on the host in float64; a
call with a tensor argument runs on that tensor's device and dtype.
"""

from __future__ import annotations

import ast
import functools
import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch


# ---------------------------------------------------------------------------
# infix expression compiler
# ---------------------------------------------------------------------------


def _lift(torch_fn: Callable, host_fn: Callable) -> Callable:
    """A math function over tensors and plain numbers: plain numbers only
    go to ``host_fn``; otherwise every argument becomes a tensor like the
    first tensor argument and goes to ``torch_fn``."""

    def call(*args):
        ref = next((a for a in args if torch.is_tensor(a)), None)
        if ref is None:
            return host_fn(*args)
        return torch_fn(*[a if torch.is_tensor(a) else torch.as_tensor(
            a, dtype=ref.dtype, device=ref.device) for a in args])

    return call


def _log2(x):
    return math.log(x, 2)


_ALLOWED_CALLS = {
    "exp": _lift(torch.exp, math.exp),
    "log": _lift(torch.log, math.log),
    "ln": _lift(torch.log, math.log),
    "log10": _lift(torch.log10, math.log10),
    "log2": _lift(torch.log2, _log2),
    "sqrt": _lift(torch.sqrt, math.sqrt),
    "abs": _lift(torch.abs, abs),
    "sin": _lift(torch.sin, math.sin),
    "cos": _lift(torch.cos, math.cos),
    "tan": _lift(torch.tan, math.tan),
    "tanh": _lift(torch.tanh, math.tanh),
    "sinh": _lift(torch.sinh, math.sinh),
    "cosh": _lift(torch.cosh, math.cosh),
    "arcsin": _lift(torch.arcsin, math.asin),
    "arccos": _lift(torch.arccos, math.acos),
    "arctan": _lift(torch.arctan, math.atan),
    "floor": _lift(torch.floor, math.floor),
    "ceil": _lift(torch.ceil, math.ceil),
    "pow": _lift(torch.pow, pow),
    "power": _lift(torch.pow, pow),
    "min": _lift(torch.minimum, min),
    "max": _lift(torch.maximum, max),
}

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.Call, ast.Name,
    ast.Constant, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow,
    ast.USub, ast.UAdd, ast.Load,
)

_CONSTANTS = {"pi": math.pi, "exponentiale": math.e, "e": math.e,
              "true": 1.0, "false": 0.0, "avogadro": 6.02214076e23}


class ExprError(ValueError):
    """Unsupported or malformed model math."""


def parse_expr(formula: str) -> ast.Expression:
    """Parse an infix math string (PEtab/SBML style, ``^`` = power) into a
    validated Python AST."""
    source = str(formula).replace("^", "**")
    try:
        tree = ast.parse(source, mode="eval")
    except SyntaxError as err:
        raise ExprError(f"cannot parse formula {formula!r}: {err}") from None
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ExprError(
                f"unsupported construct {type(node).__name__} in "
                f"formula {formula!r}")
        if isinstance(node, ast.Call):
            if (not isinstance(node.func, ast.Name)
                    or node.func.id not in _ALLOWED_CALLS):
                raise ExprError(f"unsupported function call in {formula!r}")
    return tree


@functools.lru_cache(maxsize=4096)
def _compiled(formula: str):
    """``(code, free symbols)`` of a validated formula, built once."""
    tree = parse_expr(formula)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names.add(node.id)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            names.discard(node.func.id)
    names = frozenset(n for n in names if n not in _ALLOWED_CALLS)
    return compile(tree, "<sbml-math>", "eval"), names


def expr_names(formula: str) -> set:
    """Free symbols of a formula (function names excluded)."""
    return set(_compiled(str(formula))[1])


def eval_expr(formula: str, env: Dict[str, object]):
    """Evaluate a validated formula against ``env`` (names -> tensors or
    numbers); unknown names raise :class:`ExprError`."""
    code, names = _compiled(str(formula))
    scope = dict(_ALLOWED_CALLS)
    scope.update(_CONSTANTS)
    scope.update(env)
    for name in names:
        if name not in scope:
            raise ExprError(f"unknown symbol {name!r} in formula "
                            f"{formula!r} (available: model entities)")
    return eval(code, {"__builtins__": {}}, scope)


# ---------------------------------------------------------------------------
# MathML -> infix
# ---------------------------------------------------------------------------

_MATHML_OPS = {
    "plus": " + ", "minus": " - ", "times": " * ", "divide": " / ",
    "power": " ** ",
}
_MATHML_FUNCS = {
    "exp", "ln", "log", "root", "abs", "sin", "cos", "tan", "tanh",
    "sinh", "cosh", "arcsin", "arccos", "arctan", "floor", "ceiling",
}


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def mathml_to_infix(node: ET.Element) -> str:
    """Convert a MathML ``<math>``/operand element to an infix string."""
    tag = _local(node.tag)
    if tag == "math":
        children = list(node)
        if len(children) != 1:
            raise ExprError("expected a single MathML root expression")
        return mathml_to_infix(children[0])
    if tag == "ci":
        return node.text.strip()
    if tag == "cn":
        cn_type = node.get("type", "real")
        if cn_type in ("e-notation", "rational"):
            parts = [t.strip() for t in node.itertext() if t.strip()]
            if len(parts) != 2:
                raise ExprError(f"malformed <cn type={cn_type!r}>")
            a, b = float(parts[0]), float(parts[1])
            val = a * 10.0**b if cn_type == "e-notation" else a / b
            return repr(val)
        return repr(float(node.text.strip()))
    if tag == "csymbol":
        # definitionURL .../symbols/time (or avogadro)
        url = node.get("definitionURL", "")
        if url.endswith("time"):
            return "time"
        if url.endswith("avogadro"):
            return "avogadro"
        raise ExprError(f"unsupported csymbol {url!r}")
    if tag == "apply":
        children = list(node)
        op = _local(children[0].tag)
        # qualifier elements (<logbase>, <degree>) are handled by their
        # operator below, not converted as operands
        operands = [c for c in children[1:]
                    if _local(c.tag) not in ("logbase", "degree")]
        args = [mathml_to_infix(c) for c in operands]
        if op in _MATHML_OPS:
            if op == "minus" and len(args) == 1:
                return f"(-{args[0]})"
            if not args:
                raise ExprError(f"<{op}/> with no operands")
            return "(" + _MATHML_OPS[op].join(args) + ")"
        if op in _MATHML_FUNCS:
            fn = {"ceiling": "ceil", "ln": "log"}.get(op, op)
            if op == "log":
                # MathML log may carry a <logbase>
                base_elems = [c for c in children[1:]
                              if _local(c.tag) == "logbase"]
                if base_elems:
                    base = mathml_to_infix(list(base_elems[0])[0])
                    operand = args[-1]
                    return f"(log({operand}) / log({base}))"
                fn = "log10"  # MathML <log/> without base is log10
            if op == "root":
                degree_elems = [c for c in children[1:]
                                if _local(c.tag) == "degree"]
                if degree_elems:
                    deg = mathml_to_infix(list(degree_elems[0])[0])
                    return f"(({args[-1]}) ** (1.0 / ({deg})))"
                return f"sqrt({args[-1]})"
            return f"{fn}({', '.join(args)})"
        raise ExprError(f"unsupported MathML operator <{op}>")
    if tag == "piecewise":
        raise ExprError("SBML piecewise is not supported by the vendored "
                        "subset parser")
    raise ExprError(f"unsupported MathML element <{tag}>")


# ---------------------------------------------------------------------------
# SBML document model
# ---------------------------------------------------------------------------


def _as_batch(val, y: torch.Tensor) -> torch.Tensor:
    """A rate (tensor or number) as an ``[N]`` tensor like ``y``'s rows."""
    return torch.as_tensor(val, dtype=y.dtype, device=y.device).expand(
        y.shape[0])


@dataclass
class SBMLSpecies:
    id: str
    compartment: str
    initial: float
    boundary: bool = False
    constant: bool = False


@dataclass
class SBMLReaction:
    id: str
    reactants: List  # (species id, stoichiometry)
    products: List
    kinetic_law: str  # infix formula


@dataclass
class SBMLModel:
    """Parsed SBML subset: everything needed to build a batched RHS."""
    species: Dict[str, SBMLSpecies] = field(default_factory=dict)
    parameters: Dict[str, float] = field(default_factory=dict)
    compartments: Dict[str, float] = field(default_factory=dict)
    reactions: List[SBMLReaction] = field(default_factory=list)
    rate_rules: Dict[str, str] = field(default_factory=dict)
    assignment_rules: Dict[str, str] = field(default_factory=dict)

    # ---- derived structure ------------------------------------------------

    def state_ids(self) -> List[str]:
        """Dynamic state order: non-boundary non-constant species not
        governed by an assignment rule, then rate-rule-only targets
        (parameters under a rate rule)."""
        out = []
        for sid, sp in self.species.items():
            if sp.constant or sid in self.assignment_rules:
                continue
            out.append(sid)
        for target in self.rate_rules:
            if target not in out and target not in self.species:
                out.append(target)
        return out

    def y0(self) -> List[float]:
        vals = []
        for sid in self.state_ids():
            if sid in self.species:
                vals.append(self.species[sid].initial)
            else:
                vals.append(self.parameters[sid])
        return vals

    def base_env(self) -> Dict[str, float]:
        """Constant symbols: compartment sizes + (non-state) parameters +
        constant species."""
        env = dict(self.compartments)
        state = set(self.state_ids())
        for pid, val in self.parameters.items():
            if pid not in state:
                env[pid] = val
        for sid, sp in self.species.items():
            if sp.constant:
                env[sid] = sp.initial
        return env

    def resolve_assignments(self, env: Dict[str, object]
                            ) -> Dict[str, object]:
        """Evaluate assignment rules (topologically, bounded depth) into
        ``env``; returns the extended env."""
        env = dict(env)
        pending = dict(self.assignment_rules)
        for _ in range(len(pending) + 1):
            if not pending:
                break
            progressed = False
            for target, formula in list(pending.items()):
                if expr_names(formula) <= set(env) | set(_ALLOWED_CALLS):
                    env[target] = eval_expr(formula, env)
                    del pending[target]
                    progressed = True
            if not progressed:
                raise ExprError(
                    f"cyclic or unresolvable assignment rules: "
                    f"{sorted(pending)}")
        return env

    def make_rhs(self) -> Callable:
        """Batched RHS ``rhs(y[N, S], theta_env) -> [N, S]`` on ``y``'s
        device.

        ``theta_env`` maps ESTIMATED parameter ids to [N]-shaped arrays
        (unscaled); everything else resolves from the document.  Returned
        as ``rhs(y, theta_env, t=0.0)`` — time enters through rate laws
        that reference the csymbol ``time``.
        """
        state = self.state_ids()
        index = {sid: i for i, sid in enumerate(state)}
        base = self.base_env()

        def rhs(y, theta_env, t=0.0):
            env = dict(base)
            env.update(theta_env)
            env["time"] = t
            for sid, i in index.items():
                env[sid] = y[:, i]
            # boundary species: state participates in rate laws but is
            # held by rules/constants if also assigned
            env = self.resolve_assignments(env)
            def comp_size(sid):
                # the compartment size must come from env, not the static
                # document: condition-table overrides (or estimation) of
                # a size would otherwise change kinetic-law symbols but
                # not this stoichiometric division
                return env.get(self.species[sid].compartment, 1.0)

            n = y.shape[0]
            dydt = [torch.zeros(n, dtype=y.dtype, device=y.device)
                    for _ in state]
            for rxn in self.reactions:
                rate = _as_batch(eval_expr(rxn.kinetic_law, env), y)
                for sid, stoich in rxn.reactants:
                    if sid in index and not self.species[sid].boundary:
                        dydt[index[sid]] = (dydt[index[sid]]
                                            - stoich * rate / comp_size(sid))
                for sid, stoich in rxn.products:
                    if sid in index and not self.species[sid].boundary:
                        dydt[index[sid]] = (dydt[index[sid]]
                                            + stoich * rate / comp_size(sid))
            for target, formula in self.rate_rules.items():
                dydt[index[target]] = _as_batch(eval_expr(formula, env), y)
            return torch.stack(dydt, dim=-1)

        return rhs


_UNSUPPORTED_LISTS = {
    "listOfEvents": "events",
    "listOfFunctionDefinitions": "function definitions",
    "listOfInitialAssignments": "initial assignments",
    "listOfConstraints": "constraints",
}


def parse_sbml(path_or_string: str) -> SBMLModel:
    """Parse an SBML file (or XML string) into the subset model."""
    text = path_or_string
    if not path_or_string.lstrip().startswith("<"):
        with open(path_or_string) as f:
            text = f.read()
    root = ET.fromstring(text)
    model_elems = [c for c in root if _local(c.tag) == "model"]
    if not model_elems:
        raise ExprError("no <model> element in SBML document")
    melem = model_elems[0]

    doc = SBMLModel()
    amount_species: List[str] = []
    for section in melem:
        tag = _local(section.tag)
        if tag in _UNSUPPORTED_LISTS:
            raise ExprError(
                f"SBML {_UNSUPPORTED_LISTS[tag]} are not supported by the "
                "vendored subset parser")
        if tag == "listOfCompartments":
            for c in section:
                doc.compartments[c.get("id")] = float(c.get("size", 1.0))
        elif tag == "listOfSpecies":
            for s in section:
                init = s.get("initialConcentration")
                if init is None:
                    init = s.get("initialAmount")
                    # a NONZERO amount only coincides with concentration
                    # in a unit compartment; anything else would silently
                    # mis-simulate (the /size division assumes
                    # concentrations) — checked after all sections parse.
                    # Zero amounts (empty product species) and absent
                    # initials (set via condition tables) are fine.
                    if init is not None and float(init) != 0.0:
                        amount_species.append(s.get("id"))
                    init = init if init is not None else "0"
                if s.get("hasOnlySubstanceUnits") == "true":
                    raise ExprError(
                        f"species {s.get('id')!r} uses "
                        "hasOnlySubstanceUnits, which the vendored subset "
                        "parser does not support (concentration semantics "
                        "only)")
                doc.species[s.get("id")] = SBMLSpecies(
                    id=s.get("id"),
                    compartment=s.get("compartment", ""),
                    initial=float(init),
                    boundary=s.get("boundaryCondition") == "true",
                    constant=s.get("constant") == "true")
        elif tag == "listOfParameters":
            for p in section:
                doc.parameters[p.get("id")] = float(p.get("value", 0.0))
        elif tag == "listOfRules":
            for r in section:
                rtag = _local(r.tag)
                math_elems = [c for c in r if _local(c.tag) == "math"]
                if not math_elems:
                    raise ExprError(f"rule without <math> for "
                                    f"{r.get('variable')!r}")
                formula = mathml_to_infix(math_elems[0])
                if rtag == "rateRule":
                    doc.rate_rules[r.get("variable")] = formula
                elif rtag == "assignmentRule":
                    doc.assignment_rules[r.get("variable")] = formula
                else:
                    raise ExprError(f"unsupported rule type <{rtag}>")
        elif tag == "listOfReactions":
            for r in section:
                reactants, products, law = [], [], None
                for part in r:
                    ptag = _local(part.tag)
                    if ptag in ("listOfReactants", "listOfProducts"):
                        dest = (reactants if ptag == "listOfReactants"
                                else products)
                        for ref in part:
                            dest.append((ref.get("species"),
                                         float(ref.get("stoichiometry",
                                                       1.0))))
                    elif ptag == "kineticLaw":
                        math_elems = [c for c in part
                                      if _local(c.tag) == "math"]
                        if not math_elems:
                            raise ExprError(
                                f"reaction {r.get('id')!r} kineticLaw "
                                "without <math>")
                        # local kineticLaw parameters: SBML scopes them
                        # per-reaction, but this subset flattens them into
                        # the global table — an id collision would
                        # silently rebind other formulas, so it raises
                        local_env = {}
                        for sub in part:
                            if _local(sub.tag) in ("listOfParameters",
                                                   "listOfLocalParameters"):
                                for p in sub:
                                    local_env[p.get("id")] = float(
                                        p.get("value", 0.0))
                        law = mathml_to_infix(math_elems[0])
                        for pid in local_env:
                            if pid in doc.parameters or pid in doc.species \
                                    or pid in doc.compartments:
                                raise ExprError(
                                    f"local kineticLaw parameter {pid!r} "
                                    f"in reaction {r.get('id')!r} collides "
                                    "with a global id (per-reaction "
                                    "scoping is not supported)")
                        doc.parameters.update(local_env)
                if law is None:
                    raise ExprError(
                        f"reaction {r.get('id')!r} has no kinetic law")
                doc.reactions.append(SBMLReaction(
                    id=r.get("id"), reactants=reactants,
                    products=products, kinetic_law=law))
    for sid in amount_species:
        size = doc.compartments.get(doc.species[sid].compartment, 1.0)
        if size != 1.0:
            raise ExprError(
                f"species {sid!r} declares initialAmount in a "
                f"compartment of size {size} — amount/concentration "
                "conversion is not supported by the vendored subset "
                "parser (use initialConcentration or a unit compartment)")
    return doc
