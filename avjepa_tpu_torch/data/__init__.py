"""Host-side data pipeline; the datasets themselves are shared with
``avjepa_tpu.data``, whose dataset modules import no JAX."""
