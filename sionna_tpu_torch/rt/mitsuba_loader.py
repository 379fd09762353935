"""Mitsuba-XML + PLY scene loading and export.

PyTorch-port counterpart of ``sionna_tpu/rt/mitsuba_loader.py``: the same
host NumPy and ``xml.etree`` code (a copy), so a bundle loads to the same
triangles and materials in both packages. The upstream sionna.rt scenes
(munich, etoile, simple_street_canyon) ship as a Mitsuba 3 XML scene
description referencing binary PLY meshes; this module parses that
format (shapes, BSDF -> radio material mapping, ``to_world``
transforms) without Mitsuba or Dr.Jit, so
``load_scene("/path/to/munich/munich.xml")`` works for any user holding
the upstream assets.

Supported surface:
- ``<shape type="ply"|"obj">`` with ``<string name="filename">``,
  a material reference (``<ref name="bsdf" id="mat-itu_concrete"/>``
  or an inline ``<bsdf id=...>``), and an optional
  ``<transform name="to_world">`` composed of matrix / translate /
  scale / rotate elements (applied in document order, Mitsuba
  semantics).
- PLY meshes in ``ascii 1.0`` and ``binary_little_endian 1.0``
  formats with arbitrary vertex properties (x/y/z extracted) and
  fan-triangulated n-gon faces.
- BSDF ids map to radio materials by stripping the conventional
  ``mat-`` prefix (upstream scene convention); unknown materials fall
  back to ``default_material``.

:func:`export_mitsuba_xml` writes any Scene back out as XML + binary PLY
(one mesh per material, float32 vertices).
"""

import os
import struct
import xml.etree.ElementTree as ET

import numpy as np

__all__ = ["load_ply", "load_mitsuba_xml", "export_mitsuba_xml"]


_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path):
    """Loads a PLY mesh as (vertices [V, 3] float64, faces [F, 3]
    int64).  Supports ``ascii 1.0`` and ``binary_little_endian 1.0``
    with arbitrary vertex properties; n-gon faces are fan-
    triangulated."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []          # (name, count, [(prop_kind, ...)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            parts = line.decode("ascii", "replace").split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property":
                if cur is None:
                    raise ValueError(f"{path}: property before "
                                     "element")
                if parts[1] == "list":
                    cur[2].append(("list", _PLY_DTYPES[parts[2]],
                                   _PLY_DTYPES[parts[3]], parts[4]))
                else:
                    cur[2].append(("scalar", _PLY_DTYPES[parts[1]],
                                   parts[2]))
            elif parts[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt!r} "
                             "(ascii / binary_little_endian only)")

        verts = None
        faces = []
        for name, count, props in elements:
            if fmt == "binary_little_endian":
                data = _read_ply_binary(f, count, props)
            else:
                data = _read_ply_ascii(f, count, props)
            if name == "vertex":
                cols = {}
                for i, p in enumerate(props):
                    if p[0] == "scalar":
                        cols[p[2]] = data[i]
                try:
                    verts = np.stack(
                        [cols["x"], cols["y"], cols["z"]],
                        axis=-1).astype(np.float64)
                except KeyError:
                    raise ValueError(
                        f"{path}: vertex element lacks x/y/z")
            elif name == "face":
                for i, p in enumerate(props):
                    if p[0] == "list" and p[3] in (
                            "vertex_indices", "vertex_index"):
                        for idx in data[i]:
                            for k in range(1, len(idx) - 1):
                                faces.append(
                                    (idx[0], idx[k], idx[k + 1]))
    if verts is None:
        raise ValueError(f"{path}: no vertex element")
    faces = np.asarray(faces, np.int64) if faces \
        else np.zeros((0, 3), np.int64)
    return verts, faces


def _read_ply_binary(f, count, props):
    """Reads ``count`` rows of ``props`` from a little-endian binary
    PLY body.  Fixed-stride fast path when no list properties are
    present."""
    if all(p[0] == "scalar" for p in props):
        dt = np.dtype([(f"c{i}", "<" + p[1])
                       for i, p in enumerate(props)])
        raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt,
                            count=count)
        return [raw[f"c{i}"] for i in range(len(props))]
    out = [[] for _ in props]
    for _ in range(count):
        for i, p in enumerate(props):
            if p[0] == "scalar":
                v = np.frombuffer(
                    f.read(np.dtype(p[1]).itemsize),
                    dtype="<" + p[1])[0]
                out[i].append(v)
            else:
                n = int(np.frombuffer(
                    f.read(np.dtype(p[1]).itemsize),
                    dtype="<" + p[1])[0])
                idx = np.frombuffer(
                    f.read(np.dtype(p[2]).itemsize * n),
                    dtype="<" + p[2])
                out[i].append(idx.astype(np.int64))
    return [np.asarray(o) if props[i][0] == "scalar" else o
            for i, o in enumerate(out)]


def _read_ply_ascii(f, count, props):
    out = [[] for _ in props]
    for _ in range(count):
        parts = f.readline().split()
        pos = 0
        for i, p in enumerate(props):
            if p[0] == "scalar":
                out[i].append(float(parts[pos]))
                pos += 1
            else:
                n = int(parts[pos])
                out[i].append(np.asarray(
                    [int(x) for x in parts[pos + 1:pos + 1 + n]],
                    np.int64))
                pos += 1 + n
    return [np.asarray(o) if props[i][0] == "scalar" else o
            for i, o in enumerate(out)]


# ----------------------------------------------------------------------
# Transforms
# ----------------------------------------------------------------------
def _parse_transform(elem):
    """4x4 to_world matrix from a Mitsuba ``<transform>`` element:
    children are applied in document order (each later element acts on
    the result of the earlier ones), so M = T_n @ ... @ T_1."""
    m = np.eye(4)
    for child in elem:
        tag = child.tag.lower()
        if tag == "matrix":
            vals = [float(x) for x in child.get("value").split()]
            if len(vals) == 16:
                t = np.asarray(vals).reshape(4, 4)
            elif len(vals) == 9:
                t = np.eye(4)
                t[:3, :3] = np.asarray(vals).reshape(3, 3)
            else:
                raise ValueError("matrix value must have 9 or 16 "
                                 "entries")
        elif tag == "translate":
            t = np.eye(4)
            t[:3, 3] = _xyz(child, 0.)
        elif tag == "scale":
            t = np.eye(4)
            if child.get("value") is not None:
                vals = [float(x)
                        for x in child.get("value").split()]
                if len(vals) == 1:
                    vals = vals * 3
                t[0, 0], t[1, 1], t[2, 2] = vals
            else:
                t[0, 0], t[1, 1], t[2, 2] = _xyz(child, 1.)
        elif tag == "rotate":
            axis = _xyz(child, 0.)
            n = np.linalg.norm(axis)
            if n == 0:
                raise ValueError("rotate needs a nonzero axis")
            x, y, z = axis / n
            ang = np.deg2rad(float(child.get("angle", 0.)))
            c, s = np.cos(ang), np.sin(ang)
            r = np.array([
                [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                 x * z * (1 - c) + y * s],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                 y * z * (1 - c) - x * s],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                 c + z * z * (1 - c)]])
            t = np.eye(4)
            t[:3, :3] = r
        else:
            continue   # lookat etc. are camera-only; ignore
        m = t @ m
    return m


def _xyz(elem, default):
    if elem.get("value") is not None:
        vals = [float(x) for x in elem.get("value").split()]
        if len(vals) == 1:
            vals = vals * 3
        return np.asarray(vals)
    return np.asarray([float(elem.get(a, default))
                       for a in ("x", "y", "z")])


def _material_from_bsdf_id(bsdf_id, known_materials,
                           default_material):
    """Maps a Mitsuba BSDF id to a radio-material name (upstream
    scene convention: BSDF 'mat-itu_concrete' -> material
    'itu_concrete')."""
    for cand in (bsdf_id, bsdf_id[4:] if bsdf_id.startswith("mat-")
                 else bsdf_id):
        if cand in known_materials:
            return cand
    return default_material


def load_mitsuba_xml(path, default_material="itu_concrete"):
    """Parses a Mitsuba 3 scene XML into (triangles [T, 3, 3] float64,
    material_names list[str]).  Mesh filenames resolve relative to the
    XML's directory."""
    from .radio_materials import ITU_MATERIALS

    base = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()
    known = set(ITU_MATERIALS)

    # Top-level BSDF declarations: id -> material name
    bsdf_by_id = {}
    for bsdf in root.iter("bsdf"):
        bid = bsdf.get("id")
        if bid:
            bsdf_by_id[bid] = _material_from_bsdf_id(
                bid, known, default_material)

    tris, mats = [], []
    for shape in root.iter("shape"):
        stype = shape.get("type", "").lower()
        if stype not in ("ply", "obj"):
            continue
        fname = None
        for s in shape.findall("string"):
            if s.get("name") == "filename":
                fname = s.get("value")
        if fname is None:
            raise ValueError(
                f"{path}: shape {shape.get('id')!r} has no filename")
        fpath = fname if os.path.isabs(fname) \
            else os.path.join(base, fname)
        if stype == "ply":
            verts, faces = load_ply(fpath)
        else:
            from .scene import load_obj
            tri_v, _ = load_obj(fpath, default_material)
            verts = tri_v.reshape(-1, 3)
            faces = np.arange(verts.shape[0],
                              dtype=np.int64).reshape(-1, 3)

        # to_world transform
        for t in shape.findall("transform"):
            if t.get("name") in (None, "to_world", "toWorld"):
                m = _parse_transform(t)
                verts = verts @ m[:3, :3].T + m[:3, 3]
                if np.linalg.det(m[:3, :3]) < 0:
                    # mirrored transform flips winding; restore it so
                    # normals keep their orientation convention
                    faces = faces[:, ::-1]
                break

        # material: <ref name="bsdf" id=.../> or inline <bsdf id=...>
        mat = None
        for ref in shape.findall("ref"):
            rid = ref.get("id")
            if rid in bsdf_by_id and ref.get("name") in (None, "bsdf"):
                mat = bsdf_by_id[rid]
        if mat is None:
            inline = shape.find("bsdf")
            if inline is not None:
                mat = _material_from_bsdf_id(
                    inline.get("id") or "", known, default_material)
        if mat is None:
            # fall back to the shape id (upstream also names shapes
            # after their material, e.g. 'mesh-itu_concrete_0')
            sid = shape.get("id") or ""
            for k in known:
                if k in sid:
                    mat = k
                    break
        if mat is None:
            mat = default_material

        if faces.shape[0]:
            tris.append(verts[faces])
            mats += [mat] * faces.shape[0]

    if tris:
        triangles = np.concatenate(tris, axis=0)
    else:
        triangles = np.zeros((0, 3, 3), np.float64)
    return triangles, mats


# ----------------------------------------------------------------------
# Exporter (round-trip fixtures + upstream interop)
# ----------------------------------------------------------------------
def _write_ply(path, verts, faces):
    """Binary little-endian PLY with float32 vertices."""
    with open(path, "wb") as f:
        f.write(b"ply\n")
        f.write(b"format binary_little_endian 1.0\n")
        f.write(f"element vertex {verts.shape[0]}\n".encode())
        f.write(b"property float x\nproperty float y\n"
                b"property float z\n")
        f.write(f"element face {faces.shape[0]}\n".encode())
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        for face in faces:
            f.write(struct.pack("<Biii", 3, *[int(i) for i in face]))


def export_mitsuba_xml(scene, path):
    """Writes ``scene`` as a Mitsuba 3 XML + binary PLY bundle (one
    mesh per material, vertices deduplicated), loadable by
    :func:`load_mitsuba_xml` and by upstream Mitsuba tooling.
    Returns the XML path."""
    base = os.path.dirname(os.path.abspath(path))
    mesh_dir = os.path.join(base, "meshes")
    os.makedirs(mesh_dir, exist_ok=True)

    root = ET.Element("scene", version="2.1.0")
    ET.SubElement(root, "default", name="spp", value="4096")

    names = list(scene._tri_material_names)
    tris = np.asarray(scene.triangles, np.float64)
    order = sorted(set(names), key=lambda m: names.index(m))
    for mat in order:
        bsdf = ET.SubElement(root, "bsdf", type="twosided",
                             id=f"mat-{mat}")
        inner = ET.SubElement(bsdf, "bsdf", type="diffuse")
        ET.SubElement(inner, "rgb", value="0.5 0.5 0.5",
                      name="reflectance")
    for i, mat in enumerate(order):
        sel = np.asarray([m == mat for m in names])
        t = tris[sel]
        flat = np.round(t.reshape(-1, 3), 9)
        verts, inv = np.unique(flat, axis=0, return_inverse=True)
        faces = inv.reshape(-1, 3)
        mesh_name = f"mesh-{mat}_{i}.ply"
        _write_ply(os.path.join(mesh_dir, mesh_name),
                   verts.astype(np.float32), faces)
        shape = ET.SubElement(root, "shape", type="ply",
                              id=f"mesh-{mat}_{i}")
        ET.SubElement(shape, "string", name="filename",
                      value=f"meshes/{mesh_name}")
        ET.SubElement(shape, "boolean", name="face_normals",
                      value="true")
        ET.SubElement(shape, "ref", id=f"mat-{mat}", name="bsdf")

    tree = ET.ElementTree(root)
    ET.indent(tree)
    tree.write(path, encoding="unicode", xml_declaration=True)
    return path
