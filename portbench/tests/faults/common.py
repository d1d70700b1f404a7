"""What the faults of every mode share."""


def moved(text: str) -> str:
    """The first mapped record of a batch's text one base to the right."""
    lines = text.split("\n")
    for i, ln in enumerate(lines):
        f = ln.split("\t")
        if len(f) > 3 and not int(f[1]) & 4:
            f[3] = str(int(f[3]) + 1)
            lines[i] = "\t".join(f)
            break
    return "\n".join(lines)
