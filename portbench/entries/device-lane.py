"""Entry of the configurations whose `mode` is "device-lane": map with
the configuration's `map_flags` (`--device-exact` or `--device-pass1`),
as cli.py's cmd_map builds its engine and calls device_lane
(_device_lane) and run_device_lane (_run_device_lane).  The traffic's
batch is the lane's (SMALT_DX_BATCH's default, 4,096 mate rows, but in
the tests' tiny runs); settings of the lane such as SMALT_DX_P2 come from
the configuration's `env`."""
from portbench.errors import RunError


def reads_per_write(cell) -> int:
    """Reads (pairs) of one batch, which the port writes at once: the
    lane takes `batch` mate rows, so batch / 2 pairs."""
    t = cell.traffic
    return t["batch"] // 2 if cell.mates == 2 else t["batch"]


def build(cell, prefix: str, reads: list, device: str):
    from smalt_tpu_torch import cli
    from smalt_tpu_torch.map.pipeline import device_lane, run_device_lane
    argv = list(cell.config["map_flags"]) + [prefix] + reads
    a = cli._map_argparser("smalt_tpu_torch map").parse_args(argv)
    if not (a.device_exact or a.device_pass1):
        raise RunError("map_flags name no device lane")
    flag = "--device-exact" if a.device_exact else "--device-pass1"
    engine, refset, _ = cli._build_engine(a, argv)
    lane, plane, what = device_lane(
        engine, a.reads, "sam", True, False, False, a.aliout,
        exact=a.device_exact, mates_path=a.mates, ihist=None, resume=False,
        device=device, batch=cell.traffic["batch"])
    if what != f"the {flag} lane":
        raise RunError(f"{flag} did not take the run: {what} maps")

    def call(out):
        run_device_lane(lane, engine, a.reads, out, refset, fmt="sam",
                        soft_clip=True, x_mismatch=False,
                        seed=(a.randseed if a.randseed is not None else 0),
                        fix_primary=False, ali_out=a.aliout,
                        mates_path=a.mates, plane=plane, ihist=None,
                        resume_log=None)
    return call
