"""Loss per step of consensus LM training with the full xlstm-125m
vocabulary, in the JAX reference and in the port.

Not a test: a measurement behind the loss check of ``chip_smoke.py``'s
full-width phase (PERF.md, ROADMAP.md C). It runs both trainers with the
example's flags (4 workers, batch 16, seq 128, 2 local steps, lr 2e-3,
``--groups leaf``, 3 steps) at the smoke width and depth (d_model 256, 2
layers) but with xlstm-125m's vocabulary of 50304 tokens, and prints each
package's loss after every step. With 512 tokens (the smoke config) every
row of the tied embedding meets a gradient in each batch; with 50304 most
rows see only the ADMM proximal term, which Adam's normalisation turns into
a full learning-rate step. Run on the CPU (about two minutes):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_vocab_probe.py
"""
import time

from repro.configs import base as jbase
from repro.launch import train as jtrain
from repro_torch.configs import base
from repro_torch.launch import train

FLAGS = ["--arch", "xlstm-125m", "--smoke", "--workers", "4", "--batch",
         "16", "--seq", "128", "--local-steps", "2", "--lr", "2e-3",
         "--tau0", "5.0", "--xi", "0.999", "--bits", "6", "--omega",
         "0.9995", "--groups", "leaf", "--steps", "3", "--log-every", "1"]


def main():
    runs = {}
    for name, cfg_mod, trainer, extra in (
            ("jax", jbase, jtrain, []),
            ("port", base, train, ["--device", "cpu"])):
        smoke = cfg_mod.get_smoke_config
        cfg_mod.get_smoke_config = \
            lambda arch, smoke=smoke: smoke(arch).with_overrides(
                vocab_size=50304)
        try:
            t0 = time.perf_counter()
            runs[name] = trainer.main(FLAGS + extra)["history"]
        finally:
            cfg_mod.get_smoke_config = smoke
        print(f"{name}: loss per step {runs[name]} "
              f"({time.perf_counter() - t0:.0f} s)")


if __name__ == "__main__":
    main()
