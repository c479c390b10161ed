"""theora_tpu: a JAX/XLA video codec framework with the capabilities of
Theora (VP3-derived): 8x8 DCT + quantization + DC prediction +
motion-compensated inter prediction + in-loop deblocking + DCT-token Huffman
entropy coding, bit-exact with the Theora specification on the decode side.

Architecture (accelerator-first, not a port):
  - Pixel/transform work (iDCT/fDCT, quantize, MC, recon, loop filter, SAD/SATD)
    runs as batched tensor programs over all fragments of a frame
    (JAX/XLA, on a GPU); the reference's per-block C/assembly loops have
    no analogue here.
  - Bit-serial entropy coding and Ogg packet assembly run on host (numpy /
    C++), structured around the per-(plane, zigzag) token-list layout that
    makes coefficient reconstruction data-parallel.
  - Multi-device scaling shards keyframe-delimited GOPs / independent frames
    across a jax.sharding.Mesh; see theora_tpu.parallel.

Reference behavior documented against xiph/theora (libtheora 1.2);
citations in docstrings are file:line into that tree.
"""

__version__ = "0.1.0"

from theora_tpu.info import TheoraInfo, PixelFormat, ColorSpace  # noqa: F401
