"""smalt_tpu_torch — the PyTorch/CUDA port of smalt_tpu.

The JAX package `smalt_tpu` is the reference.  This package stands on
its own: it imports torch, never jax, and nothing of `smalt_tpu`.  Its
device modules re-implement the reference's in torch, with the TPU's
Pallas kernels rewritten by hand for NVIDIA Hopper; its host layers are
its own copies of the reference's framework-free modules, kept byte for
byte where nothing had to change (tests/test_torch_standalone.py holds
them equal and lists the modules changed on purpose).  Both packages
read and write the same `.smt.npz` / `.smx.npz` index files.

Layer map:
  native/    the C extension (swdp.c, mapcore.c, fastlane.c), built with
             `cc` into native/_smalt_<platform>.so at first import
  seq/ index/ seed/ segment/ align/ results/ report/ tools/
             host layers: sequence IO, index build, seeding, collation,
             host Smith-Waterman, result sets, SAM/BAM output
  map/engine.py    the exact per-read mapping engine (host)
  map/pipeline.py  host `map` pipelines + the `--device-exact` entry
  map/fastlane.py  the C lanes (FastLane, PairLane) and DeviceExact
  map/fastmode.py  `map --fast`: host readers and tail + the device pass
  parallel/mesh.py           device index and the fast mapping step
  parallel/exact_collate.py  the device-exact collate step
  parallel/exact_pass2.py    device pass 2 (ops/csrc/swq.cu)
  ops/sw.py    Smith-Waterman wrappers: CUDA kernels (ops/csrc/sw_full.cu,
               sw_band.cu) + their plain torch versions
  ops/bounds.py  cells, bytes and roofline bounds of the kernels
  ops/build.py   nvcc build of ops/csrc/*.cu into build/kernels/ at
                 first launch
  cli.py       `python -m smalt_tpu_torch.cli index|map|sample|check`

Tests on the CPU: `python -m pytest tests/test_torch_*.py -q`.
On the GPU: `python3 chip_smoke.py`.
"""

__version__ = "0.1.0"
