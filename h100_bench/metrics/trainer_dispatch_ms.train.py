"""The median over the traced stretch's recorded training iterations of
the host milliseconds of the program's ``trainer.fetch``,
``trainer.augment`` and ``trainer.step`` spans (utils/timer.py), their
waits on the card (``augment.read``) left out: the host's share of getting
one step onto the card. None where the program records no spans."""
import statistics


def read(ctx):
    try:
        from segmentation_pipeline_torch.utils.timer import host_ms, recorded
    except ImportError:
        return None
    spans = recorded()["spans"]
    iterations = {s.id: 0.0 for s in spans if s.name == "trainer.iteration"}
    for s in spans:
        if s.name in ("trainer.fetch", "trainer.augment", "trainer.step") \
                and s.request in iterations:
            iterations[s.request] += host_ms(s, spans)
    if not iterations:
        return None
    return statistics.median(iterations.values())
