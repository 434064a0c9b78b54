"""The port imports without jax and never reaches into the JAX package,
PIL or torchvision (its image readers are its own, ``png.py`` and
``jpeg.py``, numpy and the standard library only).  The
picture libraries, cv2, matplotlib and imageio, are imported only inside
the functions that draw (``viz.py`` and the two examples that write
pictures), so importing any module of the port loads none of them: the
card's host has cv2 but neither matplotlib nor imageio."""

import ast
import pathlib
import subprocess
import sys

import pytest
from torch_scene import one_torch_thread  # noqa: F401

PKG = pathlib.Path(__file__).resolve().parent.parent / "diffdope_tpu_torch"
REF = PKG.parent / "diffdope_tpu"
#: the port's modules that carry a module of the reference, under its name
PORTED = (
    "bop.py", "camera.py", "config.py", "diffdope.py", "geometry.py", "image.py",
    "losses.py", "mesh.py", "metrics.py", "object3d.py", "optimize.py", "parallel.py",
    "testing.py", "viz.py", "render/antialias.py", "render/fused_loss.py",
    "render/gather_rows.py", "render/interpolate.py", "render/pack_kernel.py",
    "render/pipeline.py", "render/planar.py", "render/raster_v3.py",
    "render/rasterize.py", "render/setup_tris.py", "render/shade.py",
    "render/texture.py",
)


def test_torch_package_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib, diffdope_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'diffdope_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'diffdope_tpu', 'cv2', 'PIL', 'torchvision')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=PKG.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr


#: never imported by the port
FORBIDDEN = ("jax", "jaxlib", "optax", "diffdope_tpu", "PIL", "torchvision")
#: imported only inside functions, and only by the modules that draw
PICTURES = ("cv2", "matplotlib", "imageio")
DRAWING = ("viz.py", "examples/simple_scene.py", "examples/appearance_refinement.py")


def _imports(nodes):
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(PKG)) for p in PKG.rglob("*.py"))
)
def test_torch_sources_import_no_jax(path):
    tree = ast.parse((PKG / path).read_text())
    for root in _imports(ast.walk(tree)):
        assert root not in FORBIDDEN, (path, root)
    in_functions = {id(n) for f in ast.walk(tree)
                    if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                    for n in ast.walk(f)}
    for root in _imports(n for n in ast.walk(tree) if id(n) not in in_functions):
        assert root not in PICTURES, (path, root, "imported at module level")
    if path not in DRAWING:
        for root in _imports(ast.walk(tree)):
            assert root not in PICTURES, (path, root)


#: what the image readers may import: numpy, the standard library's
#: byte tools and each other, and ``os`` (the OpenEXR reader reads cv2's
#: gate, ``OPENCV_IO_ENABLE_OPENEXR``, from the environment)
READER_IMPORTS = {"__future__", "array", "functools", "os", "pathlib", "struct", "typing",
                  "zlib", "numpy", "diffdope_tpu_torch"}


@pytest.mark.parametrize("path", ["png.py", "jpeg.py", "tiff.py", "netpbm.py", "bmp.py",
                                  "webp.py", "gif.py", "sunras.py", "hdr.py", "exr.py"])
def test_torch_image_readers_import_numpy_only(path):
    tree = ast.parse((PKG / path).read_text())
    assert set(_imports(ast.walk(tree))) <= READER_IMPORTS, path


def test_torch_bop_entry_points_import_without_jax_or_cv2():
    """``bop.py`` and every script, imported and their argument parsers run
    (``--help``), pull in neither jax, the JAX package nor cv2; the
    scripts sit where the reference's do, by name."""
    code = (
        "import sys, contextlib, io\n"
        "from diffdope_tpu_torch import bop\n"
        "from diffdope_tpu_torch.examples import (appearance_refinement, multichip_refine,\n"
        "    run_bop_scene, run_bop_sweep, simple_scene)\n"
        "for main in (run_bop_scene.main, run_bop_sweep.main, simple_scene.main,\n"
        "             appearance_refinement.main, multichip_refine.main):\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        try:\n"
        "            main(['--help'])\n"
        "        except SystemExit as e:\n"
        "            assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'diffdope_tpu', 'cv2', 'matplotlib', 'imageio', 'PIL', 'torchvision')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=PKG.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for name in ("run_bop_scene.py", "run_bop_sweep.py", "simple_scene.py",
                 "appearance_refinement.py", "multichip_refine.py"):
        assert (PKG / "examples" / name).exists(), name
        assert (PKG.parent / "examples" / name).exists(), name


def test_torch_modules_keep_the_reference_names():
    for name in PORTED:
        assert (PKG / name).exists(), name
        assert (REF / name).exists(), name


def test_torch_wrappers_refuse_unsupported_devices():
    """A wrapper takes its plain version only for CPU tensors; any other
    device that is not CUDA raises instead of falling back."""
    import torch

    from diffdope_tpu_torch.render import fused_loss, pack_kernel, raster
    from diffdope_tpu_torch.render.rasterize import raster_ids

    rows = torch.zeros((1, 32, 16, 16), device="meta")
    ids = torch.zeros((1, 16, 16), dtype=torch.int32, device="meta")
    gt6 = torch.zeros((6, 16, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_loss.loss_sums(rows, ids, gt6, (0, 0, 16, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_loss.loss_bwd(rows, ids, gt6, (0, 0, 16, 16),
                            torch.zeros((1, 3), device="meta"))
    one = torch.zeros(1, dtype=torch.int32, device="meta")  # one tile's off_c, used
    with pytest.raises(ValueError, match="unsupported device"):
        raster.raster_bwd(rows, ids, 64, (16, 16), one, one, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        raster.raster_compact(torch.zeros((1, 32, 64), device="meta"),
                              *(torch.zeros(1, dtype=torch.int32, device="meta"),) * 3,
                              32, (16, 16), (16, 16), (0, 0, 16, 16))
    mvpm = torch.zeros((1, 20), device="meta")
    tab = torch.zeros((20, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pack_kernel.pack_fwd(mvpm, tab, torch.zeros((1, 8), device="meta"), 3)
    with pytest.raises(ValueError, match="unsupported device"):
        pack_kernel.pack_bwd(mvpm, tab, torch.zeros((1, 32, 8), device="meta"), 3)
    with pytest.raises(ValueError, match="unsupported device"):  # K8
        raster_ids(torch.zeros((1, 4, 16), device="meta"),
                   torch.zeros((1, 128), dtype=torch.int32, device="meta"),
                   torch.zeros(1, dtype=torch.int32, device="meta"), (16, 16), (16, 16))


def test_torch_new_wrappers_refuse_unsupported_devices():
    """K9's and K10's wrappers, like the others, take the plain versions for
    CPU tensors only."""
    import torch

    from diffdope_tpu_torch.render import gather_rows, raster_v3

    i32 = dict(dtype=torch.int32, device="meta")
    tile_idx, counts = torch.zeros((1, 128), **i32), torch.zeros(1, **i32)
    with pytest.raises(ValueError, match="unsupported device"):  # K9 forward
        gather_rows.gather_rows_fwd(torch.zeros((1, 4, 32), device="meta"), tile_idx,
                                    counts, (16, 16), (16, 16))
    with pytest.raises(ValueError, match="unsupported device"):  # K9 backward
        gather_rows.gather_rows_bwd(torch.zeros((1, 32, 16, 16), device="meta"),
                                    torch.zeros((1, 16, 16), **i32), counts, 128, (16, 16))
    tables = raster_v3.Tables(
        torch.zeros(4, dtype=torch.long, device="meta"),
        torch.zeros(4, dtype=torch.long, device="meta"), torch.zeros(1, **i32),
        torch.zeros(1, **i32), torch.zeros((1, 1), **i32), torch.zeros((1, 1), **i32),
        raster_v3.K_CHUNK, raster_v3.K_CHUNK)
    with pytest.raises(ValueError, match="unsupported device"):  # K10 forward
        raster_v3.raster_v3_fwd(torch.zeros((1, 32, raster_v3.K_CHUNK), device="meta"),
                                tables, (16, 16), (16, 16))
    with pytest.raises(ValueError, match="unsupported device"):  # K10 backward
        raster_v3.raster_v3_bwd(torch.zeros((1, 32, 16, 16), device="meta"),
                                torch.zeros((1, 16, 16), **i32), tables, (16, 16))


def test_torch_colour_lane_wrappers_refuse_unsupported_devices():
    """K5/K6 with colour planes, like every wrapper, take the plain
    versions for CPU tensors only, and check the planes' shape."""
    import torch

    from diffdope_tpu_torch.render import fused_loss

    rows = torch.zeros((1, 32, 16, 16), device="meta")
    ids = torch.zeros((1, 16, 16), dtype=torch.int32, device="meta")
    gt6 = torch.zeros((6, 16, 16), device="meta")
    colors = torch.zeros((1, 3, 16, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_loss.loss_sums(rows, ids, gt6, (0, 0, 16, 16), colors=colors)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_loss.loss_bwd(rows, ids, gt6, (0, 0, 16, 16),
                            torch.zeros((1, 3), device="meta"), colors=colors)
    with pytest.raises(ValueError, match="colors"):
        fused_loss.loss_sums(torch.zeros((1, 32, 16, 16)),
                             torch.zeros((1, 16, 16), dtype=torch.int32),
                             torch.zeros((6, 16, 16)), (0, 0, 16, 16),
                             colors=torch.zeros((1, 2, 16, 16)))


def test_torch_bf16_lane_and_segment_sum_refuse_unsupported_devices():
    """The bf16 lane of K6 and K4 and rasterize's segmented sum take their
    plain versions for CPU tensors only; the bf16 lane is the rgb + mask
    lane's alone."""
    import torch

    from diffdope_tpu_torch.render import fused_loss, raster
    from diffdope_tpu_torch.render.rasterize import setup_rows_bwd

    rows = torch.zeros((1, 32, 16, 16), device="meta")
    ids = torch.zeros((1, 16, 16), dtype=torch.int32, device="meta")
    gt6 = torch.zeros((6, 16, 16), device="meta")
    d_sums = torch.zeros((1, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_loss.loss_bwd(rows, ids, gt6, (0, 0, 16, 16), d_sums,
                            d_rows_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rgb \\+ mask lane only"):
        fused_loss.loss_bwd(rows, ids, gt6, (0, 0, 16, 16), d_sums,
                            dplane=torch.zeros((1, 16, 16), device="meta"),
                            d_rows_dtype=torch.bfloat16)
    one = torch.zeros(1, dtype=torch.int32, device="meta")  # one tile's off_c, used
    with pytest.raises(ValueError, match="unsupported device"):
        raster.raster_bwd(rows.to(torch.bfloat16), ids, 64, (16, 16), one, one, 32)
    with pytest.raises(ValueError, match="unsupported device"):
        setup_rows_bwd(torch.zeros((1, 256, 16), device="meta"),
                       torch.zeros((1, 256), dtype=torch.int32, device="meta"), 8)


def test_torch_texture_op_is_exported():
    """The nvdiffrast-style texture op is the package's, as the reference
    exports its own."""
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch.render.texture import texture

    assert tdd.texture is texture


#: the names the reference's ``__init__.py`` exports beyond the port's
#: first slices, each from the port module that defines it
EXPORTS = {
    "LOSS_REGISTRY": "losses", "register_loss": "losses", "dist_batch_lr": "losses",
    "l1_rgb_with_mask": "losses", "l1_depth_with_mask": "losses", "l1_mask": "losses",
    "add_metric": "metrics", "adds_metric": "metrics", "add_auc": "metrics",
    "object_diameter": "metrics", "quat_from_matrix33": "geometry",
}


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_torch_package_exports_the_reference_names(name):
    import importlib

    import diffdope_tpu_torch as tdd

    module = importlib.import_module(f"diffdope_tpu_torch.{EXPORTS[name]}")
    assert getattr(tdd, name) is getattr(module, name)


def test_torch_package_has_every_reference_export():
    """Every name the reference's ``__init__.py`` binds (read with ast, the
    JAX package not imported) is an attribute of the port's package."""
    import diffdope_tpu_torch as tdd

    tree = ast.parse((REF / "__init__.py").read_text())
    names = [a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom)
             for a in n.names]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets]
    assert len(names) > 30
    assert [n for n in names if not hasattr(tdd, n)] == []
