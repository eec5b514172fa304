"""Mean passes of the label scan (``ops.com.label_components``, one host
sync each) a frame: the ``passes`` of the program's ``detect.scan`` spans in
the profiled window."""

from bench_torch.metrics import _program_spans


def read(rec):
    passes = [s.attrs["passes"] for s in _program_spans.in_window(rec, "detect.scan")
              if "passes" in s.attrs]
    return sum(passes) / len(passes) if passes else None
