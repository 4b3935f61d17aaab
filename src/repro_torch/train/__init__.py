"""Training on one card: ``schedule`` (warmup then cosine), ``optimizer``
(AdamW, Adafactor, SGD, global-norm clipping), ``compression`` (int8
gradients with error feedback) and ``train_loop`` (``TrainState``,
``init_train_state``, ``make_train_step`` with microbatch accumulation)."""
