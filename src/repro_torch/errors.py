"""Typed failure taxonomy for the FMM pipeline.

Every loud failure path in the solver raises one of these instead of a
bare ``RuntimeError``/``ValueError``, so callers can branch on *what*
failed:

  ValidationError      caller handed us malformed arguments (shape,
                       dtype, batch layout) — always the caller's bug
  CapOverflowError     the connectivity caps dropped interactions — the
                       answer would be silently wrong; recoverable by
                       raising the caps
  NonFiniteInputError  z or q contain NaN/Inf — garbage in; fail before
                       trusting anything computed from it
  NonFiniteOutputError phi contains NaN/Inf on finite input — a kernel
                       or expansion bug
  RecoveryExhaustedError  every rung of the guarded-execution ladder
                       (``repro_torch.solver.guard``) failed
  DeviceUnavailableError  the solver was asked for a device this process
                       cannot use (no CUDA card); there is no silent
                       fall-back to the CPU
  DeadlineExceededError   a served request's deadline budget ran out
                       before it was dispatched (``repro_torch.serve``)
  OversizedRequestError   a served request is larger than the bucket
                       lattice and the direct fall-back bound
  MeshError            a device mesh does not fit the process group
                       (``repro_torch.launch.mesh``)

and one warning, ``BackendDowngradeWarning``: an entry point dispatches
another backend than the one asked for (``apply_batched`` on a
``batched_dispatch="fallback"`` backend).

The classes multiply-inherit the builtin a plain implementation would
raise (``ValueError`` for validation, ``RuntimeError`` for overflow), so
``except RuntimeError`` call sites keep working.
"""
from __future__ import annotations


class FmmError(Exception):
    """Base class of every typed FMM failure."""


class ValidationError(FmmError, ValueError):
    """Malformed solver arguments (shape / dtype / batch layout)."""


class ShapeError(ValidationError):
    """Argument shape does not match the solver's static config."""


class DTypeError(ValidationError, TypeError):
    """Argument dtype confusion (real positions, precision loss, ...)."""


class CapOverflowError(FmmError, RuntimeError):
    """Connectivity caps overflowed: interactions would be dropped.

    Carries ``margins`` — the per-class cap margins (slots left before
    overflow; negative = entries dropped) keyed by
    ``repro_torch.core.fmm.HEALTH_CLASSES`` — and the scalar ``overflow``.
    """

    def __init__(self, message: str, *, margins: dict | None = None,
                 overflow: int = 0):
        super().__init__(message)
        self.margins = dict(margins or {})
        self.overflow = int(overflow)


class NonFiniteInputError(FmmError, ValueError):
    """z or q contain NaN/Inf — refusing to compute on garbage."""


class NonFiniteOutputError(FmmError, ArithmeticError):
    """phi contains NaN/Inf on finite input (kernel/expansion fault)."""


class RecoveryExhaustedError(FmmError, RuntimeError):
    """Every rung of the guarded-execution ladder failed.

    Carries ``report`` — the ``GuardReport`` of the failed walk."""

    def __init__(self, message: str, *, report=None):
        super().__init__(message)
        self.report = report


class DeadlineExceededError(FmmError, TimeoutError):
    """A served request's deadline budget ran out before it could be
    dispatched (admission control, ``repro_torch.serve``). The request was
    shed, not computed — retrying with a fresh budget is the caller's
    call."""


class OversizedRequestError(ValidationError):
    """A served request's N exceeds the bucket lattice *and* the direct
    O(N^2) fallback bound — no shape class can absorb it. Recorded as the
    typed rejection in a ``ServeReport`` by the serving plane's admission
    controller."""


class DeviceUnavailableError(FmmError, RuntimeError):
    """The requested device is not usable in this process (e.g. the
    default ``cuda`` device on a machine without a CUDA card)."""


class MeshError(FmmError, ValueError):
    """A device mesh was asked for that the process group cannot hold:
    no default process group, or a world of another size than the
    mesh's (``jax.make_mesh`` refuses a mesh larger than its devices with
    a ``ValueError``)."""


class BackendDowngradeWarning(RuntimeWarning):
    """A solver entry point dispatches a different backend than requested
    (e.g. ``apply_batched`` on a ``batched_dispatch="fallback"`` backend
    runs the "reference" hooks): same answer, other timings."""
