"""Typed key/value property store used during scene construction.

Replaces PropertyList (include/nori/proplist.h:31-137): the XML parser
fills one of these per object, plugin constructors pull typed values
with defaults.  Types: boolean, integer, float, string, color, point,
vector, transform.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from nori_tpu_torch.registry import NoriError
from nori_tpu_torch.core.transform import Transform

_MISSING = object()


class PropertyList:
    def __init__(self):
        self._props: Dict[str, Tuple[str, Any]] = {}

    def _set(self, kind: str, name: str, value: Any):
        self._props[name] = (kind, value)

    def _get(self, kind: str, name: str, default=_MISSING):
        if name not in self._props:
            if default is _MISSING:
                raise NoriError(f"Property '{name}' is missing")
            return default
        stored_kind, value = self._props[name]
        if stored_kind != kind:
            raise NoriError(
                f"Property '{name}' has the wrong type "
                f"(expected {kind}, got {stored_kind})"
            )
        return value

    def has(self, name: str) -> bool:
        return name in self._props

    def names(self):
        return list(self._props)

    # typed accessors ------------------------------------------------------
    def set_boolean(self, n, v): self._set("boolean", n, bool(v))
    def get_boolean(self, n, default=_MISSING) -> bool:
        return self._get("boolean", n, default)

    def set_integer(self, n, v): self._set("integer", n, int(v))
    def get_integer(self, n, default=_MISSING) -> int:
        return self._get("integer", n, default)

    def set_float(self, n, v): self._set("float", n, float(v))
    def get_float(self, n, default=_MISSING) -> float:
        return self._get("float", n, default)

    def set_string(self, n, v): self._set("string", n, str(v))
    def get_string(self, n, default=_MISSING) -> str:
        return self._get("string", n, default)

    def set_color(self, n, v):
        self._set("color", n, np.asarray(v, dtype=np.float64).reshape(3))
    def get_color(self, n, default=_MISSING) -> np.ndarray:
        v = self._get("color", n, default)
        if v is default and not isinstance(v, np.ndarray) and v is not None:
            v = np.asarray(v, dtype=np.float64) * np.ones(3)
        return v

    def set_point(self, n, v):
        self._set("point", n, np.asarray(v, dtype=np.float64).reshape(3))
    def get_point(self, n, default=_MISSING) -> np.ndarray:
        return self._get("point", n, default)

    def set_vector(self, n, v):
        self._set("vector", n, np.asarray(v, dtype=np.float64).reshape(3))
    def get_vector(self, n, default=_MISSING) -> np.ndarray:
        return self._get("vector", n, default)

    def set_transform(self, n, v: Transform):
        self._set("transform", n, v)
    def get_transform(self, n, default=_MISSING) -> Transform:
        return self._get("transform", n, default)

    def __repr__(self):
        items = ", ".join(f"{k}={v[1]!r}" for k, v in self._props.items())
        return f"PropertyList[{items}]"
