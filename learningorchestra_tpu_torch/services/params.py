"""Artifact lookup by name (the part of the JAX package's
``services/params.py`` that serving needs; the ``$``/``#`` parameter
DSL is not ported yet)."""

from __future__ import annotations

from typing import Optional


class ParameterResolver:
    def __init__(self, context: "ServiceContext"):  # noqa: F821
        self._ctx = context

    def artifact_type(self, name: str) -> Optional[str]:
        """The stored type string of artifact ``name``, or None."""
        return self._ctx.artifacts.find(name)
