"""The paper's workload: band matrices and the distributed SpMV."""
