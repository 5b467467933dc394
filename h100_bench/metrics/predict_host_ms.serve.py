"""The median over the traced requests of the predictor's host
milliseconds: each recorded ``predict`` span of the program (utils/timer.py)
that no sweep encloses, less its waits on the card (``predict.read``).
None where the program records no spans."""
import statistics


def read(ctx):
    try:
        from segmentation_pipeline_torch.utils.timer import host_ms, recorded
    except ImportError:
        return None
    spans = recorded()["spans"]
    by_id = {s.id: s for s in spans}

    def in_sweep(s):
        while s.parent is not None and s.parent in by_id:
            s = by_id[s.parent]
            if s.name == "trainer.sweep":
                return True
        return False
    values = [host_ms(s, spans) for s in spans if s.name == "predict" and not in_sweep(s)]
    return statistics.median(values) if values else None
