"""mpibwa-tpu: a BWA-MEM-class read aligner with its seeding on a GPU.

From-scratch re-design of the capabilities of bioinfo-pf-curie/mpiBWA
(see SURVEY.md / DESIGN.md) in JAX/XLA with exact bwa-mem 0.7.17 output
semantics.
"""

__version__ = "0.1.0"
