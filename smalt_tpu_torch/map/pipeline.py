"""The `--device-exact` branch of the serial single-end pipeline.

Counterpart of the device_exact branch of
smalt_tpu.map.pipeline.run_pipeline_raw_fastq (pipeline.py:183-238): the
same worker state, strict-FASTQ check and host batch renderer, with the
port's DeviceExact lane.  Where the reference quietly runs its host lane
instead (input the bulk parser does not take, an engine the device lane
refuses), this raises NotImplementedError naming the ROADMAP.md item.
"""
from __future__ import annotations

from smalt_tpu.map import pipeline as ref_pipeline
from smalt_tpu.map.fastlane import FastLane
from smalt_tpu.seq import codec
from smalt_tpu.seq.io import Read

from .fastlane import DeviceExact


def run_device_exact_fastq(engine, path: str, out, refset, fmt: str = "sam",
                           soft_clip: bool = True, x_mismatch: bool = False,
                           seed: int = 1, fix_primary: bool = False,
                           ali_out: bool = False,
                           device="cuda", batch: int = 0) -> DeviceExact:
    """Map the single-end FASTQ `path` through the device-exact lane on
    `device`, writing headerless records to `out` in input order.
    Returns the lane, whose counters (n_restaged, p2_used, p2_fb,
    p2_hit, host_batches) describe the run."""
    g = ref_pipeline._g
    lane = FastLane.make(engine, fmt, soft_clip, x_mismatch, ali_out,
                         fix_primary)
    dev = DeviceExact.make(engine, fmt, soft_clip, x_mismatch, ali_out,
                           fix_primary, batch=batch, device=device)
    if lane is None or dev is None:
        raise NotImplementedError(
            "--device-exact for this engine (the reference runs its host "
            "lane) is not ported yet (ROADMAP.md Queue 1 #6e)")
    if not ref_pipeline._strict_fastq(path):
        raise NotImplementedError(
            "--device-exact on input other than strict 4-line FASTQ is not "
            "ported yet (ROADMAP.md Queue 1 #6e)")
    ref_pipeline._init_worker(engine, (fmt, soft_clip, x_mismatch, refset,
                                       ali_out), seed)
    g["ihist"] = None           # single-end: no insert histogram
    g["fix_primary"] = fix_primary
    g["reseed_per_block"] = False
    g["lane"] = lane

    def fallback_batch(names, seqs, quals):
        # no RNG was consumed: the batch goes through the host lane's
        # block renderer (which may itself use the Python engine)
        text = lane.render_raw_block(names, seqs, quals)
        if text is not None:
            return text
        reads = [Read(name=n.decode(), seq=codec.encode(s), qual=q)
                 for n, s, q in zip(names, seqs, quals)]
        return "".join(ref_pipeline._render_block(args) for args in
                       ref_pipeline._blocks(iter(reads),
                                            ref_pipeline.BLOCK_READS))

    dev.run_raw_fastq(path, out, fallback_batch)
    return dev
