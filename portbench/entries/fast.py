"""Entry of the configurations whose `mode` is "fast": map --fast, as
cli.py's _cmd_map_fast calls run_fast_pipeline, with the CLI's defaults,
the configuration's `map_flags` (such as `--mesh DP,IP`), and the
traffic's `-n` (`nthreads`) and batch."""


def reads_per_write(cell) -> int:
    """Reads (pairs) of one batch, which the port writes at once."""
    return cell.traffic["batch"]


def build(cell, prefix: str, reads: list, device: str):
    from smalt_tpu_torch import cli
    from smalt_tpu_torch.index.table import KmerIndex
    from smalt_tpu_torch.map.fastmode import run_fast_pipeline
    from smalt_tpu_torch.results import pairs as pairs_mod
    from smalt_tpu_torch.seq.refset import RefSet
    t = cell.traffic
    argv = (["--fast", "-n", str(t["nthreads"])] +
            list(cell.config.get("map_flags", [])) + [prefix] + reads)
    a = cli._map_argparser("smalt_tpu_torch map").parse_args(argv)
    refset, idx = RefSet.load(prefix), KmerIndex.load(prefix)

    def call(out):
        run_fast_pipeline(
            refset, idx, a.reads, out, batch=t["batch"],
            penalties=cli._parse_penalties(a.scorspec),
            minscor=(a.minscor if a.minscor is not None else 18),
            nthreads=a.nthreads, device=device, mates_path=a.mates,
            insert_min=a.insertmin, insert_max=a.insertmax,
            exact_engine=None,
            seed=(a.randseed if a.randseed is not None else 1),
            mesh_spec=a.mesh_spec, libcode=pairs_mod.LIB_PAIREDEND, ihist=None,
            index_name=prefix)
    return call
