"""Model families (reference: exastencils_tpu/models/)."""
