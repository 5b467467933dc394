"""Milliseconds (host clock) per training iteration of the trainer's
evaluations in the traced stretch: the program's ``trainer.train_eval``,
``trainer.sweep`` and ``trainer.val_eval`` spans (utils/timer.py, recorded
only while the profiler runs) summed, over the number of recorded
``trainer.iteration`` spans. None where the program records no spans."""


def read(ctx):
    try:
        from segmentation_pipeline_torch.utils.timer import recorded
    except ImportError:
        return None
    spans = recorded()["spans"]
    iterations = sum(1 for s in spans if s.name == "trainer.iteration")
    if not iterations:
        return None
    names = ("trainer.train_eval", "trainer.sweep", "trainer.val_eval")
    return sum(s.ms for s in spans if s.name in names) / iterations
