"""XML scene-description parser.

Re-implements the tag grammar of the reference parser
(src/parser.cpp:28-317) on top of xml.etree: object tags
(scene/mesh/bsdf/emitter/camera/integrator/sampler/rfilter/test/...)
instantiate plugins through the factory registry; property tags
(boolean/integer/float/string/point/vector/color/transform) fill the
parent's PropertyList; transform tags accumulate translate/matrix/
scale/rotate/lookat operations.  Children are wired with
add_child/set_parent and each object is finalized with activate()
bottom-up, exactly like the reference lifecycle.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from nori_tpu_torch.registry import (
    NoriError, create_instance,
    SCENE, MESH, BSDF, PHASE, EMITTER, MEDIUM, CAMERA, INTEGRATOR,
    SAMPLER, TEST, RFILTER,
)
from nori_tpu_torch.props import PropertyList
from nori_tpu_torch.core.transform import Transform
from nori_tpu_torch.objects import get_file_resolver

# Object tags -> expected class kind (src/parser.cpp:90-103)
_OBJECT_TAGS = {
    "scene": SCENE,
    "mesh": MESH,
    "bsdf": BSDF,
    "emitter": EMITTER,
    # the fork's fixture generator emits <luminaire> (scenes/pa5/tests/polylum.py)
    "luminaire": EMITTER,
    "camera": CAMERA,
    "medium": MEDIUM,
    "phase": PHASE,
    "integrator": INTEGRATOR,
    "sampler": SAMPLER,
    "rfilter": RFILTER,
    "test": TEST,
}

_PROPERTY_TAGS = {
    "boolean", "integer", "float", "string", "point", "vector", "color",
    "transform",
}

_TRANSFORM_OPS = {"translate", "matrix", "rotate", "scale", "lookat"}


def _tokenize(s: str):
    return s.replace(",", " ").split()


def _to_vec3(s: str) -> np.ndarray:
    t = _tokenize(s)
    if len(t) == 1:
        return np.full(3, float(t[0]))
    if len(t) != 3:
        raise NoriError(f"Expected 3 values, got '{s}'")
    return np.array([float(v) for v in t])


def _to_bool(s: str) -> bool:
    ls = s.strip().lower()
    if ls == "true":
        return True
    if ls == "false":
        return False
    raise NoriError(f"Could not parse boolean value '{s}'")


def _check_attributes(node: ET.Element, allowed: set, where: str):
    attrs = set(node.attrib)
    unexpected = attrs - allowed
    if unexpected:
        raise NoriError(
            f"Unexpected attribute(s) {sorted(unexpected)} in <{node.tag}> ({where})"
        )
    missing = allowed - attrs
    if missing:
        raise NoriError(
            f"Missing attribute(s) {sorted(missing)} in <{node.tag}> ({where})"
        )


def load_from_xml(filename: str):
    """Load a scene/test description; returns the finalized root object.

    Mirrors loadFromXML (parser.h:29, src/parser.cpp:28): the scene
    directory is prepended to the file resolver so relative mesh paths
    work, same as src/main.cpp:178-183.
    """
    filename = str(filename)
    scene_dir = os.path.dirname(os.path.abspath(filename))
    get_file_resolver().prepend(scene_dir)

    try:
        tree = ET.parse(filename)
    except ET.ParseError as e:
        raise NoriError(f"Error while parsing '{filename}': {e}") from e

    root = tree.getroot()
    state = {"transform": Transform()}
    obj = _parse_tag(root, None, None, state, filename)
    if obj is None:
        raise NoriError(f"'{filename}': root element produced no object")
    return obj


def _parse_tag(node: ET.Element, parent_list, parent_tag, state, fname):
    tag = node.tag
    where = f"{fname}:<{tag}>"

    is_object = tag in _OBJECT_TAGS
    is_property = tag in _PROPERTY_TAGS
    is_transform_op = tag in _TRANSFORM_OPS

    if not (is_object or is_property or is_transform_op):
        raise NoriError(f"Unexpected tag <{tag}> in '{fname}'")

    has_parent = parent_tag is not None
    parent_is_transform = parent_tag == "transform"

    if not has_parent and not is_object:
        raise NoriError(f"Root element <{tag}> must be a Nori object ({where})")
    if parent_is_transform != is_transform_op:
        raise NoriError(
            f"Transform nodes can only contain transform operations ({where})"
        )

    if tag == "transform":
        state["transform"] = Transform()

    if is_object:
        prop_list = PropertyList()
        children = []
        for ch in node:
            child = _parse_tag(ch, prop_list, tag, state, fname)
            if child is not None:
                children.append(child)

        if tag == "scene":
            type_name = node.attrib.get("type", "scene")
            extra = set(node.attrib) - {"type"}
            if extra:
                raise NoriError(f"Unexpected attributes {sorted(extra)} ({where})")
        else:
            _check_attributes(node, {"type"}, where)
            type_name = node.attrib["type"]

        result = create_instance(type_name, prop_list)
        expected_kind = _OBJECT_TAGS[tag]
        if result.class_kind != expected_kind:
            raise NoriError(
                f"Unexpectedly constructed an object of type <{result.class_kind}> "
                f"(expected <{expected_kind}>): {result!r}"
            )
        for ch in children:
            result.add_child(ch)
            ch.set_parent(result)
        result.activate()
        return result

    # property tags ---------------------------------------------------------
    if is_property:
        if tag == "transform":
            _check_attributes(node, {"name"}, where)
            # accumulate child transform ops, then store the result
            for ch in node:
                _parse_tag(ch, parent_list, tag, state, fname)
            parent_list.set_transform(node.attrib["name"], state["transform"])
            return None
        _check_attributes(node, {"name", "value"}, where)
        name, value = node.attrib["name"], node.attrib["value"]
        if tag == "string":
            parent_list.set_string(name, value)
        elif tag == "float":
            parent_list.set_float(name, float(value))
        elif tag == "integer":
            parent_list.set_integer(name, int(value))
        elif tag == "boolean":
            parent_list.set_boolean(name, _to_bool(value))
        elif tag == "point":
            parent_list.set_point(name, _to_vec3(value))
        elif tag == "vector":
            parent_list.set_vector(name, _to_vec3(value))
        elif tag == "color":
            parent_list.set_color(name, _to_vec3(value))
        return None

    # transform operations: compose as (op * current) like parser.cpp:255-301
    cur = state["transform"]
    if tag == "translate":
        _check_attributes(node, {"value"}, where)
        op = Transform.translate(_to_vec3(node.attrib["value"]))
    elif tag == "matrix":
        _check_attributes(node, {"value"}, where)
        vals = [float(v) for v in _tokenize(node.attrib["value"])]
        if len(vals) != 16:
            raise NoriError(f"Expected 16 values ({where})")
        op = Transform(np.array(vals).reshape(4, 4))
    elif tag == "scale":
        _check_attributes(node, {"value"}, where)
        op = Transform.scale(_to_vec3(node.attrib["value"]))
    elif tag == "rotate":
        _check_attributes(node, {"angle", "axis"}, where)
        op = Transform.rotate(
            float(node.attrib["angle"]), _to_vec3(node.attrib["axis"])
        )
    elif tag == "lookat":
        _check_attributes(node, {"origin", "target", "up"}, where)
        op = Transform.lookat(
            _to_vec3(node.attrib["origin"]),
            _to_vec3(node.attrib["target"]),
            _to_vec3(node.attrib["up"]),
        )
    state["transform"] = op * cur
    return None
