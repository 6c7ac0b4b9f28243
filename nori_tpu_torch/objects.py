"""Base object model for scene-description plugins.

Replaces NoriObject (include/nori/object.h:31-104): every plugin has a
class kind, participates in the addChild/setParent wiring done by the
XML parser, and is finalized bottom-up through activate().

These are *host-side* description objects.  Device execution state is
produced separately by Scene.compile() as SoA jnp arrays — the TPU-first
split between "scene description graph" and "flat render data".
"""

from __future__ import annotations

from nori_tpu_torch.registry import NoriError


class NoriObject:
    #: class kind string, one of nori_tpu_torch.registry.CLASS_KINDS
    class_kind: str = ""
    #: name under which the plugin was registered (set by @register_class)
    plugin_name: str = ""

    parent = None

    def add_child(self, child: "NoriObject"):
        raise NoriError(
            f"{type(self).__name__}::add_child(<{child.class_kind}>) is not supported"
        )

    def set_parent(self, parent: "NoriObject"):
        self.parent = parent

    def activate(self):
        """Bottom-up finalization hook (called by the parser after wiring)."""

    def to_string(self) -> str:
        return f"{type(self).__name__}[]"

    def __repr__(self):
        return self.to_string()


class FileResolver:
    """Search-path file resolution (stand-in for filesystem::resolver,
    common.h getFileResolver)."""

    def __init__(self):
        import os
        self.paths = [os.getcwd()]

    def prepend(self, path: str):
        self.paths.insert(0, path)

    def resolve(self, name: str) -> str:
        import os
        if os.path.isabs(name) and os.path.exists(name):
            return name
        for p in self.paths:
            cand = os.path.join(p, name)
            if os.path.exists(cand):
                return cand
        return name


_resolver = FileResolver()


def get_file_resolver() -> FileResolver:
    return _resolver
