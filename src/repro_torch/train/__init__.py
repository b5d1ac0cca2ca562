from .steps import make_train_step, make_prefill_step, make_decode_step, \
    cross_entropy, init_train_state, make_loss_fn

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "cross_entropy", "init_train_state", "make_loss_fn"]
