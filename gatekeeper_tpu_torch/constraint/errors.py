# Copied from gatekeeper_tpu/constraint/errors.py; only imports and the edits noted in this header differ.
"""Constraint-framework error taxonomy (mirrors client/errors.go)."""

from __future__ import annotations


class ConstraintFrameworkError(Exception):
    """Base class for all constraint framework errors."""


class MissingTemplateError(ConstraintFrameworkError):
    """Referenced ConstraintTemplate is not registered."""


class UnrecognizedConstraintError(ConstraintFrameworkError):
    """Constraint's kind does not match any registered template."""


class MissingConstraintError(ConstraintFrameworkError):
    """Constraint not found in the client cache."""


class InvalidTemplateError(ConstraintFrameworkError):
    """ConstraintTemplate failed structural or Rego validation."""


class InvalidConstraintError(ConstraintFrameworkError):
    """Constraint failed CRD-schema or target validation."""


class ErrorMap(ConstraintFrameworkError):
    """Aggregates per-target errors (client/errors.go ErrorMap)."""

    def __init__(self, errors):
        self.errors = dict(errors)
        msg = "; ".join(f"{k}: {v}" for k, v in sorted(self.errors.items()))
        super().__init__(msg)
