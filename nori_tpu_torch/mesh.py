"""Mesh plugin (host side).

Mirrors the reference Mesh/WavefrontOBJ split (include/nori/mesh.h:74-179,
src/obj.cpp): a mesh owns its geometry plus optional BSDF and Emitter
children; a missing BSDF defaults to diffuse at activate() time
(src/mesh.cpp:35-41).  Device-side geometry is produced by
nori_tpu_torch.scene.Scene.compile().
"""

from __future__ import annotations

from nori_tpu_torch import registry
from nori_tpu_torch.objects import NoriObject, get_file_resolver
from nori_tpu_torch.props import PropertyList
from nori_tpu_torch.registry import register_class, NoriError, create_instance
from nori_tpu_torch.core.transform import Transform
from nori_tpu_torch.obj_loader import load_obj, MeshData


class Mesh(NoriObject):
    class_kind = registry.MESH

    def __init__(self):
        self.data: MeshData | None = None
        self.bsdf = None
        self.emitter = None

    def activate(self):
        if self.bsdf is None:
            self.bsdf = create_instance("diffuse", PropertyList())

    def add_child(self, child):
        if child.class_kind == registry.BSDF:
            if self.bsdf is not None:
                raise NoriError("Mesh: tried to register multiple BSDFs!")
            self.bsdf = child
        elif child.class_kind == registry.EMITTER:
            if self.emitter is not None:
                raise NoriError("Mesh: tried to register multiple Emitters!")
            self.emitter = child
        else:
            super().add_child(child)

    def is_emitter(self) -> bool:
        return self.emitter is not None

    def to_string(self):
        return (
            f"Mesh[name={self.data.name if self.data else '?'}, "
            f"F={self.data.num_faces if self.data else 0}, "
            f"bsdf={self.bsdf!r}, emitter={self.emitter!r}]"
        )


@register_class("obj")
class WavefrontOBJ(Mesh):
    def __init__(self, props: PropertyList):
        super().__init__()
        import os

        name = props.get_string("filename")
        filename = get_file_resolver().resolve(name)
        to_world = props.get_transform("toWorld", Transform())
        if not os.path.exists(filename) and \
                os.path.basename(name) == "ajax.obj":
            # the ~544k-triangle ajax scan referenced by the pa2/pa3/
            # pa5 scenes is not shipped in the reference checkout
            # (external Jotero-forum asset); substitute a procedurally
            # generated mesh of the same triangle count, placed to fill
            # the same camera frustum, so the ajax-class scenes stay
            # runnable end-to-end and benchmarkable at full scale.
            from nori_tpu_torch.scenes_builtin import ajax_standin_meshdata

            print("(ajax.obj not in checkout; using the procedural "
                  "544k-triangle stand-in)")
            self.data = ajax_standin_meshdata()
            if to_world is not None:
                self.data = self.data.transformed(to_world)
            return
        self.data = load_obj(filename, to_world)
