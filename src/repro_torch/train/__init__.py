"""The LM scaffold's training and serving — port of ``repro.train``:
``optim`` (AdamW), ``steps`` (the train state, the train step and the
serve steps), ``checkpoint`` (``Checkpointer``) and ``loop``
(``train_loop``)."""
