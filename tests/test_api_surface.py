"""Public-API surface parity with the reference.

Walks every public module-level def/class (and UPPERCASE constant) of the
reference's importable surface and asserts an attribute of the same name
exists in the corresponding module here (reference modules listed in
SURVEY.md section 2). Skips when /root/reference is absent.
"""
import ast
import importlib
import os
import warnings

import pytest

REF = "/root/reference"

pytestmark = pytest.mark.skipif(not os.path.isdir(REF),
                                reason="reference tree not mounted")

# reference module -> modules here that together must cover its surface
PAIRS = {
    "constants.py": ["gravinv3dhmc.constants"],
    "utils.py": ["gravinv3dhmc.utils"],
    "mesher/geometry.py": ["gravinv3dhmc.mesher"],
    "mesher/mesh.py": ["gravinv3dhmc.mesher"],
    "gravmag/prism.py": ["gravinv3dhmc.ops.prism"],
    "gravmag/tesseroid.py": ["gravinv3dhmc.ops.tesseroid"],
    "gravmag/tesseroidforward.py":
        ["gravinv3dhmc.compat.gravmag.tesseroidforward"],
    "gravmag/compressor1D.py":
        ["gravinv3dhmc.compat.gravmag.compressor1D"],
    "gravmag/compressor3D.py":
        ["gravinv3dhmc.compat.gravmag.compressor3D"],
    "inversion/potential.py": ["gravinv3dhmc.compat.inversion.potential",
                               "gravinv3dhmc.inversion"],
    "inversion/hmc.py": ["gravinv3dhmc.compat.inversion.hmc",
                         "gravinv3dhmc.inversion"],
    "inversion/reginv.py": ["gravinv3dhmc.compat.inversion.reginv",
                            "gravinv3dhmc.inversion"],
    "vis/mpl.py": ["gravinv3dhmc.vis.mpl"],
    "vis/myv.py": ["gravinv3dhmc.vis.myv"],
}


def _public_defs(path):
    with open(path, encoding="utf-8", errors="replace") as fh:
        src = fh.read()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SyntaxWarning)
        tree = ast.parse(src)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Name) and not t.id.startswith("_")
                        and t.id.isupper()):
                    names.add(t.id)
    return names


def test_compat_package_exports():
    """The reference's package __init__ re-exports resolve under compat
    (reference: inversion/__init__.py:1-2, gravmag/__init__.py,
    mesher/__init__.py:4)."""
    from gravinv3dhmc import compat
    for name in ("HamitonianMC", "HMCSample", "GravMagModule",
                 "JointModule"):
        assert hasattr(compat.inversion, name)
    for name in ("kernelcompressor", "modelcompressor", "prism",
                 "tesseroid", "tesseroidforward"):
        assert hasattr(compat.gravmag, name)
    for name in ("Prism", "Tesseroid", "PrismRelief", "PrismMesh",
                 "TesseroidMesh", "PrismMeshSegment",
                 "TesseroidMeshSegment"):
        assert hasattr(compat.mesher, name)
    # submodule-style imports work like the reference's flat layout
    from gravinv3dhmc.compat.mesher import PrismMesh  # noqa: F401
    from gravinv3dhmc.compat.utils import regular  # noqa: F401
    assert hasattr(compat.vis, "mpl") and hasattr(compat.vis, "myv")


@pytest.mark.parametrize("ref_module", sorted(PAIRS))
def test_symbol_coverage(ref_module):
    ref_names = _public_defs(os.path.join(REF, ref_module))
    ours = [importlib.import_module(m) for m in PAIRS[ref_module]]
    missing = [n for n in sorted(ref_names)
               if not any(hasattr(m, n) for m in ours)]
    assert not missing, (
        f"{ref_module}: public symbols without an equivalent here: "
        f"{missing}")
