"""The port's public surface against the JAX package's, read with ``ast``
(neither package is imported).

For every module of ``diffdope_tpu/`` the port's module of the same name
(or the one ``MODULE_MAP`` names) must hold each public top-level
function, class and UPPERCASE constant, each public or dunder method, each
class attribute and dataclass field of a public class, and each named
parameter of a public function or method; the package's ``__init__.py``
must export every name the reference's exports.  The exceptions are the
lists below, one reason each: the Pallas plumbing and ROADMAP.md's "Not to
port" list, and nothing else (``test_torch_surface_exceptions_are_exact``
fails on an entry the port has come to hold or the reference has lost).
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "diffdope_tpu"
PORT = ROOT / "diffdope_tpu_torch"

#: reference modules whose counterpart in the port has another name
MODULE_MAP = {"render/raster_v2.py": "render/raster.py"}

#: reference modules with no counterpart
MODULES_NOT_PORTED = {
    "devices.py": "warm_transfers_async warms the TPU's host-to-device transfers",
    "native/__init__.py": "optional C helpers; the reference falls back to numpy, as the "
                          "port always does",
}

#: reference names (module:name or module:Class.member) with no counterpart
NAMES_NOT_PORTED = {
    "render/fused_loss.py:pick_slab_h": "the Pallas kernel's slab height; the CUDA "
                                        "kernels take 16x16 tiles",
    "render/fused_loss.py:backward_pass": "the Pallas backward's driver; K6 is called by "
                                          "fused_loss.loss_bwd",
    "render/pack_kernel.py:pack_binned_pallas": "the Pallas pack's wrapper; K1/K2 are "
                                                "pack_kernel.pack_fwd/pack_bwd",
    "render/rasterize.py:raster_ids_pallas": "the Pallas id search's wrapper; K8 is "
                                             "rasterize.raster_ids",
    "render/raster_v2.py:padded_hw": "the Pallas slab padding; the port pads to its "
                                     "16x16 tile inside each wrapper",
    "render/raster_v2.py:raster_gather_rows_compact": "the Pallas compact raster's "
                                                      "wrapper; K3/K4 are "
                                                      "raster.raster_compact",
}

#: keyword parameters not ported wherever they occur
KEYWORDS_NOT_PORTED = {
    "interpret": "Pallas interpret mode; a CPU tensor takes the plain twin",
    "axis_name": "the jax mesh axis; the port's ranks are one process group",
    "key": "a jax.random key; the port's draws take a seed",
}

#: keyword parameters of one reference function not ported: its Pallas
#: plumbing or the tile, which is the port's fixed 16x16 (pipeline.TILE_HW)
FUNCTION_KEYWORDS_NOT_PORTED = {
    "render/pipeline.py:render_batch": {
        "tile_hw": "the port's tile is pipeline.TILE_HW, 16x16",
        "max_occ": "the inverted map is sized from the bins ('auto') always"},
    "render/pipeline.py:make_fused_loss": {
        "tile_hw": "the port's tile is pipeline.TILE_HW, 16x16",
        "max_occ": "the inverted map is sized from the bins ('auto') always"},
    "render/pipeline.py:precompute_bins": {
        "tile_hw": "the port's tile is pipeline.TILE_HW, 16x16",
        "max_occ": "the inverted map is sized from the bins ('auto') always"},
    "render/fused_loss.py:fused_loss_sums": {
        "resolution": "the Pallas kernel's static frame; the port's reads the rows' shape",
        "n_attr": "the Pallas kernel's static lane count; the port's reads the rows"},
    "render/fused_loss.py:raster_loss_compact": {
        "bins_c": "the Pallas kernel's table operand; the port's op takes the table",
        "tile_counts": "the Pallas kernel's counts operand; the port's takes the table",
        "resolution": "the Pallas kernel's static frame; the port's reads the window",
        "ncmax": "the Pallas kernel's static chunk count; the port's reads the table",
        "n_attr": "the Pallas kernel's static lane count; the port's reads the table"},
    "render/planar.py:packed_planar": {
        "edge_adj": "the silhouette lane comes from the caller's adjacency mask"},
    "render/planar.py:bin_triangles_planar": {
        "sort_by_y": "the slots are y-sorted always, the reference's default"},
    "render/raster_v2.py:raster_gather_rows_v2": {
        "gated": "the Pallas kernel's (row, chunk) gating; the port's kernels gate by "
                 "each slot's box always, the output the same"},
    "render/raster_v2.py:raster_gather_rows_binned": {
        "gated": "the Pallas kernel's (row, chunk) gating; the port's kernels gate by "
                 "each slot's box always, the output the same"},
}


def _modules(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py"))


def _params(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _public(name):
    return not name.startswith("_") or (name.startswith("__") and name.endswith("__"))


def surface(path):
    """{name: params} of a module's public functions, {Class.member:
    params or None} of its public classes, {NAME: None} of its UPPERCASE
    constants, and {name: None} of what an ``__init__.py`` imports."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = None
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(m.name):
                    out[f"{node.name}.{m.name}"] = _params(m)
                elif isinstance(m, ast.AnnAssign) and isinstance(m.target, ast.Name):
                    if _public(m.target.id):
                        out[f"{node.name}.{m.target.id}"] = None
                elif isinstance(m, ast.Assign):
                    for t in m.targets:
                        if isinstance(t, ast.Name) and _public(t.id):
                            out[f"{node.name}.{t.id}"] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id.isupper() and not t.id.startswith("_"):
                    out[t.id] = None
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            for a in node.names:
                out[a.asname or a.name] = None
    if path.name == "__init__.py":
        for node in tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and _public(t.id):
                        out[t.id] = None
    return out


def missing(module):
    """What the reference module holds and its counterpart lacks, less the
    exceptions: ['name', 'function:keyword', ...]."""
    want = surface(REF / module)
    have = surface(PORT / MODULE_MAP.get(module, module))
    gaps = []
    for name, params in want.items():
        if f"{module}:{name}" in NAMES_NOT_PORTED:
            continue
        if name not in have:
            gaps.append(name)
            continue
        skip = FUNCTION_KEYWORDS_NOT_PORTED.get(f"{module}:{name}", {})
        for p in params or ():
            if p not in (have[name] or ()) and p not in KEYWORDS_NOT_PORTED and p not in skip:
                gaps.append(f"{name}:{p}")
    return gaps


@pytest.mark.parametrize("module", _modules(REF))
def test_torch_module_surface_matches_reference(module):
    if module in MODULES_NOT_PORTED:
        assert not (PORT / module).exists(), module
        return
    assert (PORT / MODULE_MAP.get(module, module)).exists(), module
    assert missing(module) == []


def test_torch_surface_exceptions_are_exact():
    """Each exception names something the reference has and the port lacks."""
    for module in MODULES_NOT_PORTED:
        assert (REF / module).exists(), module
    for entry in NAMES_NOT_PORTED:
        module, name = entry.split(":")
        assert name in surface(REF / module), entry
        assert name not in surface(PORT / MODULE_MAP.get(module, module)), entry
    used = set()
    for module in _modules(REF):
        if module in MODULES_NOT_PORTED:
            continue
        have = surface(PORT / MODULE_MAP.get(module, module))
        for name, params in surface(REF / module).items():
            for p in params or ():
                if p not in (have.get(name) or ()):
                    used.add(p)
                    used.add(f"{module}:{name}:{p}")
    assert set(KEYWORDS_NOT_PORTED) <= used
    for entry, keywords in FUNCTION_KEYWORDS_NOT_PORTED.items():
        for p in keywords:
            assert f"{entry}:{p}" in used, (entry, p)
