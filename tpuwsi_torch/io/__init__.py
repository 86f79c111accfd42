"""Host-side data: image folders, PNG decoding, the batch prefetcher."""
