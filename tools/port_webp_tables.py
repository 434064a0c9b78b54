"""Find libwebp's constant tables in a compiled libwebp and print them as
the Python literals that ``diffdope_tpu_torch/webp.py`` holds.

Each table is found by an anchor, a run of its values that occurs in no
other table, at a known place inside it; the table is then read whole
from there (uint8, or uint16 little-endian for the AC quantizer table).

    python tools/port_webp_tables.py [LIBRARY]

LIBRARY defaults to the libwebp that Pillow bundles (``pillow.libs/
libwebp-*.so*``); cv2's ``cv2.abi3.so`` holds the same tables.
"""

import glob
import os
import struct
import sys
from typing import Dict, List, Optional

#: name -> (anchor, the anchor's index in the table, length, item bytes)
TABLES = {
    # RFC 6386 14.1: dc_qlookup and ac_qlookup
    "DC_TABLE": ([4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17], 0, 128, 1),
    "AC_TABLE": (list(range(44, 59)) + [60, 62, 64, 66], 40, 128, 2),
    # 13.5: default_coeff_probs [4][8][3][11]; band 0 of type 0 is all 128
    "COEFFS_PROBA0": ([253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128], 33, 1056, 1),
    # 13.4: coeff_update_probs [4][8][3][11]
    "COEFFS_UPDATE_PROBA": ([255] * 33 + [176, 246, 255, 255, 255, 255, 255], 0, 1056, 1),
    # 11.5: kf_bmode_probs [10 above][10 left][9]
    "BMODES_PROBA": ([231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64], 0, 900, 1),
    "ZIGZAG": ([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15], 0, 16, 1),
    "BANDS": ([0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0], 0, 17, 1),
    # 13.2: Pcat3..Pcat6 (each ends with a 0)
    "CAT3": ([173, 148, 140, 0], 0, 4, 1),
    "CAT4": ([176, 155, 140, 135, 0], 0, 5, 1),
    "CAT5": ([180, 157, 141, 134, 130, 0], 0, 6, 1),
    "CAT6": ([254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0], 0, 12, 1),
    # RFC 9649 3.7.2.1.2 and 4.2.2: code length code order, distance map
    "CODE_LENGTH_ORDER": ([17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10], 0, 19, 1),
    "CODE_TO_PLANE": ([0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a], 0, 120, 1),
}


def default_library() -> Optional[str]:
    """Pillow's bundled libwebp, or None where there is none."""
    try:
        import PIL
    except ImportError:
        return None
    root = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    found = sorted(glob.glob(os.path.join(root, "libwebp-*.so*")))
    return found[0] if found else None


def find_tables(path: str) -> Dict[str, List[int]]:
    """name -> values of each table of :data:`TABLES`, read from the first
    place its anchor occurs in the library at ``path``; KeyError names a
    table whose anchor is absent."""
    blob = open(path, "rb").read()
    out = {}
    for name, (anchor, at, length, size) in TABLES.items():
        code = "<" + "BH"[size - 1] * len(anchor)
        where = blob.find(struct.pack(code, *anchor))
        if where < 0:
            raise KeyError(f"{name}: anchor not found in {path}")
        start = where - at * size
        out[name] = list(struct.unpack("<" + "BH"[size - 1] * length,
                                       blob[start:start + length * size]))
    return out


def literal(name: str, values: List[int], per_line: int = 16) -> str:
    rows = [", ".join(str(v) for v in values[i:i + per_line])
            for i in range(0, len(values), per_line)]
    return f"{name} = (\n" + "".join(f"    {r},\n" for r in rows) + ")\n"


def main(argv):
    path = argv[0] if argv else default_library()
    if path is None:
        sys.exit("no libwebp found: pass the path of one")
    print(f"# transcribed from {os.path.basename(path)} by tools/port_webp_tables.py")
    for name, values in find_tables(path).items():
        print(literal("_" + name, values, 11 if "PROBA" in name else 16))


if __name__ == "__main__":
    main(sys.argv[1:])
