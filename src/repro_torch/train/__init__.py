"""Training — the twin of ``repro.train``: the chunked cross-entropy
(``loss``), AdamW and its schedule (``optimizer``), the train step
(``step``), the data pipeline (``data``) and checkpoints in the JAX
package's npz layout (``checkpoint``)."""
