"""The tree kernels: K4 (leaves: one compression of the element's 12 to
28 bytes each), K5 (one level), the subtrees kernel (``depth`` levels
down from width w) and the top kernel (every level from w to the root).
A digest is 32 bytes."""

from . import BLAKE2B_COMPRESSION, ELEMENT_BYTES

KERNELS = ("leaf_kernel", "level_kernel", "subtrees_kernel", "top_kernel")
LAUNCHES = ("merkle_leaves", "merkle_level", "merkle_subtrees", "merkle_top")
DIGEST = 32


def count(key, args, size):
    w = int(args[2])
    if key == "merkle_leaves":
        hashes, read, written = w, w * ELEMENT_BYTES, w * DIGEST
    elif key == "merkle_level":
        hashes, read, written = w // 2, w * DIGEST, (w // 2) * DIGEST
    elif key == "merkle_subtrees":
        hashes = w - (w >> int(args[3]))
        read, written = w * DIGEST, hashes * DIGEST
    else:
        hashes, read, written = w - 1, w * DIGEST, (w - 1) * DIGEST
    return hashes * BLAKE2B_COMPRESSION, read + written
