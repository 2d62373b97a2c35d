"""Step builders of the LM path: training, prefill and decode."""
from repro_torch.train.step import (cross_entropy, init_train_state,
                                    loss_and_grads, make_decode_step,
                                    make_prefill_step, make_train_step,
                                    train_loss)

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "init_train_state", "cross_entropy", "loss_and_grads",
           "train_loss"]
