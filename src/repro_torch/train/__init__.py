"""The train step (``step.make_train_step``, ``step.init_train_state``)."""
