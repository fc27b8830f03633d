"""The benchmark of shredword_tpu_torch on the card: BPE training jobs
on seeded corpora, held to a plain reference.  ``python3 -m portbench
--help``; see README.md."""
