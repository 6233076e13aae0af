"""pbrt-v4 scene description parser + scene builder.

TPU-native analog of /root/reference/src/loading/parser.rs (directive pull
parser), parser_target.rs (the 40-directive interface) and scene.rs
(BasicSceneBuilder's graphics-state machine + BasicScene's creation passes).
``parse_str`` / ``parse_file`` drive the directive loop into a
SceneBuilder; ``SceneBuilder.create()`` runs the creation passes and
returns the device Scene + camera + film + sampler + render settings.

Differences from the reference are deliberate, for batched device code:
object instances are flattened into the single global BVH (a two-level
BVH is a later optimization), and all spectra/textures bake to flat device
tables at create() time.
"""

from __future__ import annotations

from shimmer_tpu.loading.errors import DirectiveError

import dataclasses
from pathlib import Path

import numpy as np

from shimmer_tpu.loading.paramdict import (
    PARAM_TYPES,
    Param,
    ParameterDictionary,
    SpectrumType,
    parse_param_declaration,
)
from shimmer_tpu.loading.tokenizer import FileLoc, TokenStream

ALL_DIRECTIVES = {
    "AttributeBegin", "AttributeEnd", "Attribute", "ActiveTransform",
    "AreaLightSource", "Accelerator", "ConcatTransform", "CoordinateSystem",
    "CoordSysTransform", "ColorSpace", "Camera", "Film", "Identity",
    "Include", "Import", "LightSource", "LookAt", "MakeNamedMaterial",
    "MakeNamedMedium", "Material", "MediumInterface", "NamedMaterial",
    "ObjectBegin", "ObjectEnd", "ObjectInstance", "Option", "PixelFilter",
    "ReverseOrientation", "Rotate", "Sampler", "Scale", "Shape",
    "Integrator", "Texture", "TransformBegin", "TransformEnd",
    "TransformTimes", "Transform", "Translate", "WorldBegin", "WorldEnd",
}


def _unquote(tok: str) -> str:
    return tok[1:-1] if tok.startswith('"') else tok


def _parse_number(tok: str):
    try:
        return int(tok)
    except ValueError:
        return float(tok)


class Parser:
    """Directive pull-parser (parser.rs:15-208)."""

    def __init__(self, stream: TokenStream, target):
        self.s = stream
        self.t = target

    def _numbers(self, n: int):
        out = []
        bracketed = False
        if self.s.peek() and self.s.peek()[0] == "[":
            self.s.next()
            bracketed = True
        while len(out) < n:
            tok, loc = self.s.next()
            out.append(float(tok))
        if bracketed:
            tok, _ = self.s.next()
            assert tok == "]", f"expected ], got {tok}"
        return out

    def _string(self):
        tok, loc = self.s.next()
        if tok == "[":
            tok, loc = self.s.next()
            close, _ = self.s.next()
            assert close == "]"
        return _unquote(tok), loc

    def _params(self) -> list[Param]:
        """Parse '"type name" [values...]' pairs until the next directive."""
        params = []
        while True:
            nxt = self.s.peek()
            if nxt is None:
                break
            tok, loc = nxt
            if not tok.startswith('"'):
                break
            decl = _unquote(tok)
            parts = decl.split()
            if len(parts) != 2:
                break  # not a parameter: e.g. the quoted name of a directive
            if parts[0] not in PARAM_TYPES:
                from shimmer_tpu.loading.errors import ParameterError

                raise ParameterError(
                    f"unknown parameter type in declaration {decl!r}", loc=loc
                )
            self.s.next()
            type_, name = parts
            values = []
            nxt = self.s.peek()
            if nxt and nxt[0] == "[":
                self.s.next()
                while True:
                    tok2, _ = self.s.next()
                    if tok2 == "]":
                        break
                    values.append(self._value(tok2, type_))
            else:
                tok2, _ = self.s.next()
                values.append(self._value(tok2, type_))
            params.append(Param(type_, name, values, loc))
        return params

    @staticmethod
    def _value(tok: str, type_: str):
        if tok.startswith('"'):
            s = _unquote(tok)
            if type_ == "bool":
                return s == "true"
            return s
        if tok in ("true", "false"):
            return tok == "true"
        return _parse_number(tok)

    def parse(self):
        t = self.t
        while True:
            nxt = self.s.next()
            if nxt is None:
                break
            tok, loc = nxt
            if tok == "Include":
                name, _ = self._string()
                self.s.push_file(name)
            elif tok == "Import":
                name, _ = self._string()
                self.s.push_file(name)
            elif tok == "LookAt":
                v = self._numbers(9)
                t.look_at(v[0:3], v[3:6], v[6:9], loc)
            elif tok == "Translate":
                t.translate(self._numbers(3), loc)
            elif tok == "Scale":
                t.scale(self._numbers(3), loc)
            elif tok == "Rotate":
                v = self._numbers(4)
                t.rotate(v[0], v[1:4], loc)
            elif tok == "Transform":
                t.transform(self._numbers(16), loc)
            elif tok == "ConcatTransform":
                t.concat_transform(self._numbers(16), loc)
            elif tok == "Identity":
                t.identity(loc)
            elif tok == "CoordinateSystem":
                name, _ = self._string()
                t.coordinate_system(name, loc)
            elif tok == "CoordSysTransform":
                name, _ = self._string()
                t.coord_sys_transform(name, loc)
            elif tok == "ActiveTransform":
                self._string()  # StartTime|EndTime|All — animation unsupported
            elif tok == "TransformTimes":
                self._numbers(2)
            elif tok == "TransformBegin":
                t.attribute_begin(loc, transform_only=True)
            elif tok == "TransformEnd":
                t.attribute_end(loc, transform_only=True)
            elif tok == "ColorSpace":
                name, _ = self._string()
                t.color_space(name, loc)
            elif tok == "Option":
                params = self._params()
                t.option(params, loc)
            elif tok in (
                "Camera", "Film", "Sampler", "Integrator", "PixelFilter",
                "Accelerator",
            ):
                name, nloc = self._string()
                params = self._params()
                getattr(t, tok.lower().replace("pixelfilter", "pixel_filter"))(
                    name, params, nloc
                )
            elif tok == "WorldBegin":
                t.world_begin(loc)
            elif tok == "WorldEnd":
                pass  # legacy pbrt-v3; v4 treats EOF as end
            elif tok == "AttributeBegin":
                t.attribute_begin(loc)
            elif tok == "AttributeEnd":
                t.attribute_end(loc)
            elif tok == "Attribute":
                target_name, _ = self._string()
                params = self._params()
                t.attribute(target_name, params, loc)
            elif tok == "Shape":
                name, nloc = self._string()
                t.shape(name, self._params(), nloc)
            elif tok == "ObjectBegin":
                name, _ = self._string()
                t.object_begin(name, loc)
            elif tok == "ObjectEnd":
                t.object_end(loc)
            elif tok == "ObjectInstance":
                name, _ = self._string()
                t.object_instance(name, loc)
            elif tok == "LightSource":
                name, nloc = self._string()
                t.light_source(name, self._params(), nloc)
            elif tok == "AreaLightSource":
                name, nloc = self._string()
                t.area_light_source(name, self._params(), nloc)
            elif tok == "Material":
                name, nloc = self._string()
                t.material(name, self._params(), nloc)
            elif tok == "MakeNamedMaterial":
                name, nloc = self._string()
                t.make_named_material(name, self._params(), nloc)
            elif tok == "NamedMaterial":
                name, nloc = self._string()
                t.named_material(name, nloc)
            elif tok == "Texture":
                name, _ = self._string()
                type_, _ = self._string()
                class_, nloc = self._string()
                t.texture(name, type_, class_, self._params(), nloc)
            elif tok == "MakeNamedMedium":
                name, nloc = self._string()
                t.make_named_medium(name, self._params(), nloc)
            elif tok == "MediumInterface":
                inside, _ = self._string()
                nxt2 = self.s.peek()
                outside = ""
                if nxt2 and nxt2[0].startswith('"') and _unquote(nxt2[0]) not in ALL_DIRECTIVES:
                    # second quoted string that is not a parameter decl
                    parts = _unquote(nxt2[0]).split()
                    if len(parts) != 2 or parts[0] not in PARAM_TYPES:
                        outside, _ = self._string()
                t.medium_interface(inside, outside, loc)
            elif tok == "ReverseOrientation":
                t.reverse_orientation(loc)
            else:
                raise DirectiveError(f"unknown directive {tok!r}", loc=loc)
        t.end_of_files()


def parse_str(text: str, target, filename="<string>", search_dir=None):
    Parser(TokenStream(text, filename, search_dir), target).parse()
    return target


def parse_file(path, target):
    p = Path(path)
    return parse_str(p.read_text(), target, str(p), search_dir=p.parent)
