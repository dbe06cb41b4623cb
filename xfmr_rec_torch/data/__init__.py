"""MovieLens ETL without pandas, the synthetic corpus and the batch
pipeline."""
