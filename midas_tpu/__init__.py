"""midas_tpu — an accelerator-native metagenomic profiling framework.

A from-scratch re-design of the capabilities of MIDAS
(Metagenomic Intra-Species Diversity Analysis System, snayfach/MIDAS):
species relative abundance from universal single-copy marker genes,
pangenome gene copy-number variants (CNVs), and per-site SNP calling —
built on JAX/XLA (and one CUDA kernel) instead of Bowtie2/HS-BLASTN/pysam
subprocess pipelines.

Layer map (bottom → top):

  align/   banded Smith-Waterman (jnp + a CUDA kernel) + k-mer seed index
           (replaces bowtie2 / hs-blastn; reference midas/run/species.py:29,
           midas/run/genes.py:116, midas/run/snps.py:97)
  io/      FASTQ/FASTA streaming, 2-bit encoding, fixed-shape device batches
           (replaces midas/run/stream_seqs.py + shell pipes)
  db/      MIDAS database layout contract + packed reference arrays
           (replaces bowtie2-build / hs-blastn index)
  profile/ per-sample pipelines: species abundance, gene CNVs, SNP pileup
           (replaces midas/run/{species,genes,snps}.py)
  merge/   cross-sample mergers (replaces midas/merge/*)
  analyze/ consensus, diversity, strain tracking, gene distances
           (replaces midas/analyze/* + analysis scripts)
  dist/    jax.sharding mesh, data-parallel read sharding, psum merges
           (replaces multiprocessing.Pool / RLIMIT-bounded batching)
  cli/     run_midas / merge_midas compatible command-line surface
  dbbuild/ offline database construction (replaces vsearch/hmmer pipeline)
  testkit/ synthetic community simulator for hermetic tests
"""

__version__ = "0.1.0"
