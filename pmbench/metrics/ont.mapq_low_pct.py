"""ont.mapq_low_pct: the share of the mapped long reads whose mapq is
below 20 (mapq_low over mapped of the program's "align.mapq" spans,
summed over the traced window), in percent.  The pileup caps each base's
quality at its read's mapq, so a low mapq mutes the read for the
genotyper.  None where no read was mapped or the program counts none."""

from pmbench import program


def read(trace):
    mapped = program.count(trace, "align.mapq", "mapped")
    if not mapped:
        return None
    return 100.0 * (program.count(trace, "align.mapq", "mapq_low") or 0) / \
        mapped
