from .step import (abstract_opt_state, make_prefill_step, make_serve_step,
                   make_train_step, value_and_grad)

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step",
           "value_and_grad", "abstract_opt_state"]
