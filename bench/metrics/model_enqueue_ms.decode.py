"""Host time inside decode_step_paged a decode tick: the eager launches
of one decode step."""
from bench.readers import model_enqueue_ms


def read(run):
    return model_enqueue_ms(run, "decode")
