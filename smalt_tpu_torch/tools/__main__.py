import sys

from . import simread
from . import readutils


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        from . import __doc__ as d
        print(d, file=sys.stderr)
        return 1
    tool, rest = argv[0], argv[1:]
    if tool == "simread":
        return simread.main(rest)
    fn = getattr(readutils, tool, None)
    if fn is None:
        print(f"unknown tool: {tool}", file=sys.stderr)
        return 1
    return fn(rest)


if __name__ == "__main__":
    raise SystemExit(main())
