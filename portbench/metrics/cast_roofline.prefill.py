"""The weight casts' share of their roofline, in %: the bytes the
program's ``llama.cast`` spans count (each f32 weight read and its bf16
copy written, once a request) at the HBM rate, over the device time of
the operations inside those spans."""

LAYER = "Model step"
UNIT = "%"
MOVES = "prefill_tokens_per_s"
SOURCE = "program_counter"

from portbench import counts, program_spans  # noqa: E402


def read(w):
    found = program_spans.marked(w, "llama.cast")
    if found is None:
        return None
    moved = sum(s.counts.get("bytes", 0) for s in found)
    spent = sum(end - start for s in found
                for start, end in program_spans.inside(w, s)) / 1e9
    if moved == 0 or spent == 0:
        return None
    return 100 * moved / counts.HBM_BYTES_PER_S / spent
