"""Training and evaluation of the transducer (port of helen_tpu/train)."""
