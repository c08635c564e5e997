"""R1CS constraint system layer.

Reimplements bellman's `ConstraintSystem` surface
(bellman/src/cs.rs:14-350) in Python: circuits synthesize
into either a QAP-collecting assembly (key generation,
phase2/src/keypair_assembly.rs:15-117) or a proving
assignment (witness evaluation, bellman groth16/prover.rs:137-186).

Field scalars are canonical Python ints mod r (the exact layer); bulk math
runs on device later from the collected sparse matrices.

The port's own copy of `phase2_bn254_tpu/groth16/cs.py` (code unchanged);
file:line citations of `.rs` files are to the upstream Rust repository.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..refimpl.field import R_MOD


class SynthesisError(Exception):
    pass


class AssignmentMissing(SynthesisError):
    pass


class UnconstrainedVariable(SynthesisError):
    pass


class PolynomialDegreeTooLarge(SynthesisError):
    pass


@dataclass(frozen=True)
class Variable:
    """cs.rs:24-46; kind is "input" or "aux"."""

    kind: str
    index: int


ONE = Variable("input", 0)


class LinearCombination:
    """Sparse sum of (Variable, coeff) terms (cs.rs:51-151)."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms: list[tuple[Variable, int]] = list(terms or [])

    def __add__(self, other):
        if isinstance(other, Variable):
            return LinearCombination(self.terms + [(other, 1)])
        if isinstance(other, tuple):
            coeff, var = other
            return LinearCombination(self.terms + [(var, coeff % R_MOD)])
        if isinstance(other, LinearCombination):
            return LinearCombination(self.terms + other.terms)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, Variable):
            return LinearCombination(self.terms + [(other, R_MOD - 1)])
        if isinstance(other, tuple):
            coeff, var = other
            return LinearCombination(self.terms + [(var, (-coeff) % R_MOD)])
        if isinstance(other, LinearCombination):
            return LinearCombination(
                self.terms + [(v, (-c) % R_MOD) for v, c in other.terms]
            )
        return NotImplemented


class ConstraintSystem:
    """Base interface (alloc/alloc_input/enforce).

    `namespace(name)` is the RAII `Namespace` analog (cs.rs:255-332): a
    context manager maintaining a path stack used in error reporting; the
    assemblies themselves ignore names, exactly as the reference's do."""

    def alloc(self, annotation=None, f: Optional[Callable[[], int]] = None) -> Variable:
        raise NotImplementedError

    def alloc_input(self, annotation=None, f: Optional[Callable[[], int]] = None) -> Variable:
        raise NotImplementedError

    def enforce(self, annotation, a: LinearCombination, b: LinearCombination, c: LinearCombination):
        raise NotImplementedError

    def namespace(self, name: str):
        from contextlib import contextmanager

        @contextmanager
        def ns():
            stack = getattr(self, "_ns_path", None)
            if stack is None:
                stack = []
                self._ns_path = stack
            stack.append(str(name))
            try:
                yield self
            except SynthesisError as e:
                if not getattr(e, "_ns_annotated", False):
                    e._ns_annotated = True
                    e.args = (f"{'/'.join(stack)}: {e}",) + e.args[1:]
                raise
            finally:
                stack.pop()

        return ns()

    @property
    def path(self) -> str:
        """Current namespace path (for diagnostics)."""
        return "/".join(getattr(self, "_ns_path", []))


class KeypairAssembly(ConstraintSystem):
    """Collects the QAP sparse matrices per variable
    (keypair_assembly.rs:15-117): at/bt/ct[var] = [(coeff, constraint)]."""

    def __init__(self):
        self.num_inputs = 0
        self.num_aux = 0
        self.num_constraints = 0
        self.at_inputs: list[list[tuple[int, int]]] = []
        self.bt_inputs: list[list[tuple[int, int]]] = []
        self.ct_inputs: list[list[tuple[int, int]]] = []
        self.at_aux: list[list[tuple[int, int]]] = []
        self.bt_aux: list[list[tuple[int, int]]] = []
        self.ct_aux: list[list[tuple[int, int]]] = []

    def alloc(self, annotation=None, f=None) -> Variable:
        idx = self.num_aux
        self.num_aux += 1
        self.at_aux.append([])
        self.bt_aux.append([])
        self.ct_aux.append([])
        return Variable("aux", idx)

    def alloc_input(self, annotation=None, f=None) -> Variable:
        idx = self.num_inputs
        self.num_inputs += 1
        self.at_inputs.append([])
        self.bt_inputs.append([])
        self.ct_inputs.append([])
        return Variable("input", idx)

    def enforce(self, annotation, a, b, c):
        for lc, inp, aux in (
            (a, self.at_inputs, self.at_aux),
            (b, self.bt_inputs, self.bt_aux),
            (c, self.ct_inputs, self.ct_aux),
        ):
            for var, coeff in lc.terms:
                target = inp if var.kind == "input" else aux
                target[var.index].append((coeff % R_MOD, self.num_constraints))
        self.num_constraints += 1


class ProvingAssignment(ConstraintSystem):
    """Captures witness values + per-constraint a/b/c evaluations
    (bellman groth16/prover.rs:137-186).

    The density bool-lists ARE the DensityTracker/QueryDensity layer
    (source.rs:81-140): bases live in numpy arrays, so the reference's
    streaming `Source` iterator collapses to boolean-mask slicing at the
    multiexp call sites (groth16/prover.py)."""

    def __init__(self):
        self.input_assignment: list[int] = []
        self.aux_assignment: list[int] = []
        self.a: list[int] = []
        self.b: list[int] = []
        self.c: list[int] = []
        # density of the b query over input/aux variables
        # (bellman source.rs DensityTracker; needed to mirror the prover's
        # b_input/b_aux multiexp split)
        self.a_aux_density: list[bool] = []
        self.b_input_density: list[bool] = []
        self.b_aux_density: list[bool] = []

    def alloc(self, annotation=None, f=None) -> Variable:
        if f is None:
            raise AssignmentMissing("aux assignment missing")
        self.aux_assignment.append(f() % R_MOD)
        self.a_aux_density.append(False)
        self.b_aux_density.append(False)
        return Variable("aux", len(self.aux_assignment) - 1)

    def alloc_input(self, annotation=None, f=None) -> Variable:
        if f is None:
            raise AssignmentMissing("input assignment missing")
        self.input_assignment.append(f() % R_MOD)
        self.b_input_density.append(False)
        return Variable("input", len(self.input_assignment) - 1)

    def eval_lc(self, lc: LinearCombination, mark_a=False, mark_b=False) -> int:
        acc = 0
        for var, coeff in lc.terms:
            if var.kind == "input":
                val = self.input_assignment[var.index]
                if mark_b:
                    self.b_input_density[var.index] = True
            else:
                val = self.aux_assignment[var.index]
                if mark_a:
                    self.a_aux_density[var.index] = True
                if mark_b:
                    self.b_aux_density[var.index] = True
            acc += coeff * val
        return acc % R_MOD

    def enforce(self, annotation, a, b, c):
        self.a.append(self.eval_lc(a, mark_a=True))
        self.b.append(self.eval_lc(b, mark_b=True))
        self.c.append(self.eval_lc(c))
